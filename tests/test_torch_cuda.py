"""The port's CUDA kernel on a card: the front assembly and the two
standalone wrappers (K1, K2) against their plain PyTorch versions (bit
for bit) in float32, float64, complex64 and complex128, the factorization
through the kernel against the one through the plain version (real and
complex), gssvx on the card, transposed and conjugate solves on the card
against the same solves on the CPU, refactor on the card, solves that are
bit for bit reproducible (fused and eager), save_lu / load_lu and a
deadline-stopped factorization resumed, and the executors (the fused and
mega CUDA graphs, level waves, host offload, the host-share split), on
the card; the grid's segment graphs (fused, mega) and its host offload
with two ranks on the card; and the reference's user entry points there: the C client and
the Fortran driver (where gfortran exists) over libslu_tpu_torch.so,
every example driver, gridmap's two sub-grids with four ranks sharing the
card, pdtest --quick, and factor_dtype="df64" bit for bit "float64".

These tests need an NVIDIA GPU and skip without one.  The JAX package is
not installed beside the card, so run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import gc
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
    """Both kernels (front assembly, panel LU) against both plain
    versions, one panel_lu launch per panel of the plan."""
    lu, bvals, _ = slt.analyze(slt.Options(), make(), device=cuda)
    kernels.reset_launches()
    fk = factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=dtype,
                                  device=cuda)
    assert kernels.LAUNCHES["panel_lu"] == _panels(lu.plan)
    fp = factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=dtype,
                                  device=cuda, scatter=factor.PLAIN,
                                  panel=factor.PANEL_PLAIN)
    assert kernels.LAUNCHES["panel_lu"] == _panels(lu.plan)
    for (lk, uk), (lp, up) in zip(fk.fronts, fp.fronts):
        assert torch.equal(lk, lp) and torch.equal(uk, up)


def _panels(plan) -> int:
    """The panels of one factorization of ``plan`` (one panel_lu launch
    each)."""
    from superlu_dist_tpu_torch.ops.dense import panel_width
    return sum(panel_width(g.w)[1] for g in plan.groups)


def test_gssvx_on_the_card(cuda):
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(2).standard_normal(a.n_rows))
    kernels.reset_launches()
    x, lu, _, info = slt.gssvx(slt.Options(), a, b, device=cuda)
    assert info == 0 and lu.numeric.dtype == torch.float32
    assert lu.numeric.device.type == "cuda"
    assert kernels.LAUNCHES == {"front_assemble": len(lu.plan.groups),
                                "extend_add": 0, "assemble": 0,
                                "csr_spmv": 0,
                                "panel_lu": _panels(lu.plan)}
    assert lu.berrs[-1] <= tols.berr_target(np.float64)


def _panel_case(kind, dtype, shape, device):
    """The CPU tests' seeded panels (tests/test_torch_panel_lu.py) on the
    card: the batch, its panel columns, j0, pa, thresh, fresh flags."""
    from test_torch_panel_lu import _panel
    a, cols, j0, pa, thresh = _panel(kind, dtype, shape)
    flags = torch.zeros((a.shape[0], j0 + pa + 3), dtype=torch.int32,
                        device=device)
    return a.to(device), cols, j0, pa, thresh.to(device), flags


@pytest.mark.parametrize("kind", ["random", "tiny", "zero_pivot",
                                  "negzero"])
@pytest.mark.parametrize("shape", ["pb16", "pb16_rows_above", "pb128",
                                   "pb128_rows_above", "column_share",
                                   "pb48_pa40", "pb112_rows_above", "root",
                                   "batch147"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_panel_lu_kernel_equals_plain(cuda, dtype, shape, kind):
    """csrc/panel_lu.cu against the plain column loop bit for bit (signed
    zeros, infinities; NaNs as NaNs) on the CPU tests' cases: pb 16 and
    128, pa < pb with rows above j0, a strided column share, tiny pivots,
    a zero pivot without replacement, -0.0 seeds."""
    from test_torch_panel_lu import SHAPES, same_bits
    a, (k0, pb), j0, pa, thresh, flags = _panel_case(kind, dtype,
                                                     SHAPES[shape], cuda)
    b, fb = a.clone(), flags.clone()
    kernels.reset_launches()
    kernels.panel_lu_(a[:, :, k0:k0 + pb], j0, pa, thresh, flags)
    kernels.panel_lu_plain(b[:, :, k0:k0 + pb], j0, pa, thresh, fb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["panel_lu"] == 1
    assert same_bits(a, b) and torch.equal(flags, fb)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_panel_lu_in_a_cuda_graph(cuda, dtype):
    """The kernel captured in a CUDA graph (its snapshot from the graph's
    pool, thresh read by pointer) and replayed on new values equals the
    plain loop on those values."""
    from test_torch_panel_lu import SHAPES, same_bits
    a, (k0, pb), j0, pa, thresh, flags = _panel_case(
        "random", dtype, SHAPES["pb128_rows_above"], cuda)
    s_a, s_flags = a.clone(), flags.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        kernels.panel_lu_(s_a[:, :, k0:k0 + pb], j0, pa, thresh, s_flags)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.panel_lu_(s_a[:, :, k0:k0 + pb], j0, pa, thresh, s_flags)
    for scale in (1.0, -2.5):
        s_a.copy_(a * scale)
        s_flags.zero_()
        graph.replay()
        b, fb = a * scale, flags.clone()
        kernels.panel_lu_plain(b[:, :, k0:k0 + pb], j0, pa, thresh, fb)
        torch.cuda.synchronize()
        assert same_bits(s_a, b) and torch.equal(s_flags, fb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128],
                         ids=str)
def test_panel_lu_on_a_2d_column_share(cuda, dtype):
    """The owned panels of one rank's column share (process column 1 of
    2, the 2-D mesh tier's layout: panel p on column p % 2, its pb
    columns contiguous in the share) factored in turn, kernel against
    plain, as ``ops.dense.panel_steps`` runs them."""
    from superlu_dist_tpu_torch.ops.dense import panel_width
    from test_torch_panel_lu import same_bits
    w, m_ext, batch, npcol, pcol = 200, 260, 3, 2, 1
    pb, nsteps = panel_width(w)
    owned = [p for p in range(nsteps) if p % npcol == pcol]
    rng = np.random.default_rng(7)
    a = _rand(rng, (batch, m_ext, len(owned) * pb + 24), dtype, cuda)
    for i, p in enumerate(owned):
        r = np.arange(min(pb, w - p * pb))
        a[:, p * pb + r, i * pb + r] += 4.0 * np.sqrt(m_ext)
    b = a.clone()
    thresh = torch.tensor(1e-3, device=cuda,
                          dtype=a.real.dtype if dtype.is_complex else dtype)
    flags = torch.zeros((batch, w), dtype=torch.int32, device=cuda)
    fb = flags.clone()
    for i, p in enumerate(owned):
        j0, pa = p * pb, min(pb, w - p * pb)
        kernels.panel_lu_(a[:, :, i * pb:(i + 1) * pb], j0, pa, thresh,
                          flags)
        kernels.panel_lu_plain(b[:, :, i * pb:(i + 1) * pb], j0, pa,
                               thresh, fb)
    torch.cuda.synchronize()
    assert same_bits(a, b) and torch.equal(flags, fb)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_panel_lu_at_the_main_paths_largest_panel(cuda, dtype):
    """The largest panel of poisson3d(48)'s FACT (batch 4, m_ext 3,848,
    pb = pa = 128: four chunks of 32 pivot steps, complex128's 256 KB
    pivot block among them) bit for bit the plain loop, tiny flags too."""
    from test_torch_panel_lu import same_bits
    batch, m_ext, pb = 4, 3848, 128
    rng = np.random.default_rng(11)
    a = _rand(rng, (batch, m_ext, pb), dtype, cuda)
    r = torch.arange(pb, device=cuda)
    a[:, r, r] += 2.0 * float(np.sqrt(m_ext))
    a[0, 0, 0] = 1e-6                       # a tiny first pivot, replaced
    b = a.clone()
    thresh = torch.tensor(1e-3, device=cuda,
                          dtype=a.real.dtype if dtype.is_complex else dtype)
    flags = torch.zeros((batch, pb), dtype=torch.int32, device=cuda)
    fb = flags.clone()
    kernels.reset_launches()
    kernels.panel_lu_(a, 0, pb, thresh, flags)
    assert kernels.LAUNCHES["panel_lu"] == 1
    kernels.panel_lu_plain(b, 0, pb, thresh, fb)
    torch.cuda.synchronize()
    assert int(fb.sum()) >= 1
    assert same_bits(a, b) and torch.equal(flags, fb)


def test_panel_lu_refuses_strided_columns_on_the_card(cuda):
    a = torch.randn(2, 40, 40, device=cuda)
    flags = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unit stride"):
        kernels.panel_lu_(a.mT[:, :, :16], 0, 16,
                          torch.tensor(1e-3, device=cuda), flags)


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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("conj", [False, True])
@pytest.mark.parametrize("nrhs", [1, 16])
def test_fused_and_eager_sweeps_agree(cuda, nrhs, conj, dtype):
    """poisson3d(16) (complex values for CONJ): the lsum scatter sums in
    a fixed order, so two fused (CUDA graph) solves on one handle are
    bit for bit equal, two eager ones are, and the fused and eager sweeps
    agree bit for bit too, in both directions."""
    from superlu_dist_tpu_torch.solve.device import DeviceSolver
    a = poisson3d(16)
    if conj:
        a = _helmholtz3d(a)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    dt = {("float64", False): torch.float64, ("float32", False): torch.float32,
          ("float64", True): torch.complex128,
          ("float32", True): torch.complex64}[dtype, conj]
    num = factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=dt,
                                   device=cuda)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((lu.n, nrhs))
    if conj:
        d = d + 1j * rng.standard_normal(d.shape)
    fused = DeviceSolver(num, fused=True)
    eager = DeviceSolver(num, fused=False)
    assert fused.fused and not eager.fused
    for solve in ((lambda s: s.solve(d)),
                  (lambda s: s.solve_trans(d, conj=conj))):
        want = solve(eager)
        assert np.array_equal(solve(eager), want)
        got = solve(fused)
        assert np.array_equal(solve(fused), got)        # replay
        assert np.array_equal(got, want)
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


def test_save_load_and_resume_on_the_card(cuda, tmp_path):
    """poisson3d(12) on the card, float32 factors at the default tier:
    save_lu/load_lu gives torch.equal fronts on the card and a FACTORED
    solve at the float64 gate; a factorization stopped by a deadline at a
    group boundary resumes to fronts torch.equal to the uninterrupted
    ones (the same launches, the same cuBLAS calls)."""
    from superlu_dist_tpu_torch.persist import checkpoint
    from superlu_dist_tpu_torch.utils.deadline import Deadline

    class Countdown(Deadline):
        def __init__(self, n):
            super().__init__(0.0)
            self.n = n

        def expired_local(self):
            return self.polls > self.n

    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(7).standard_normal(a.n_rows))
    _, lu, _, info = slt.gssvx(slt.Options(), a, b, device=cuda)
    assert info == 0 and lu.numeric.dtype == torch.float32
    path = slt.save_lu(lu, str(tmp_path / "h"))
    lu2 = slt.load_lu(path)
    assert lu2.device.type == "cuda"
    assert all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
               for p, q in zip(lu.numeric.fronts, lu2.numeric.fronts))
    _, _, st, info = slt.gssvx(slt.Options(fact=slt.Fact.FACTORED), a, b,
                               lu=lu2)
    assert info == 0 and st.solve_report.berr <= tols.berr_target(np.float64)
    lu0, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    k = len(lu0.plan.groups) // 2
    ck = str(tmp_path / "ck")
    with pytest.raises(slt.DeadlineExceededError):
        factor.numeric_factorize(lu0.plan, bvals, lu0.anorm,
                                 dtype=torch.float32, device=cuda,
                                 ckpt_dir=ck, deadline=Countdown(k))
    assert checkpoint.peek(ck)["k"] == k
    _, lu3, st3, info = slt.gssvx(slt.Options(), a, b, device=cuda,
                                  resume_from=ck)
    assert info == 0 and st3.resume["groups"] == k
    assert all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
               for p, q in zip(lu.numeric.fronts, lu3.numeric.fronts))


# ---------------------------------------------------------------------------
# the executors: fused and mega CUDA graphs, level waves, host offload and
# the host-share split
# ---------------------------------------------------------------------------

def _equal(f1, f2):
    return len(f1) == len(f2) and all(
        torch.equal(l1.cpu(), l2.cpu()) and torch.equal(u1.cpu(), u2.cpu())
        for (l1, u1), (l2, u2) in zip(f1, f2))


def _within_drift(f1, f2):
    return all(torch.allclose(x.cpu().double(), y.cpu().double(),
                              rtol=tols.SCHEDULE_DRIFT_RTOL,
                              atol=tols.SCHEDULE_DRIFT_ATOL)
               for p, q in zip(f1, f2) for x, y in zip(p, q))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_replays_equal_the_stream(cuda, dtype):
    """The fused graph's first call (warm-up, capture, replay) and a
    second replay are bit for bit the eager stream's factors; the kernel's
    launches count at each replay (one per group) and at the warm-up (one
    per distinct shape key), not at the capture."""
    a = poisson3d(12)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    plan = lu.plan
    keys = len({(g.batch, g.m, g.w, g.u) for g in plan.groups})
    ref = factor.numeric_factorize(plan, bvals, lu.anorm, dtype=dtype,
                                   device=cuda, executor="stream")
    out = []
    for want in (len(plan.groups) + keys, len(plan.groups)):
        kernels.reset_launches()
        num = factor.numeric_factorize(plan, bvals, lu.anorm, dtype=dtype,
                                       device=cuda, executor="fused")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["front_assemble"] == want
        assert num.tiny_pivots == ref.tiny_pivots
        out.append(num)
    assert _equal(out[0].fronts, ref.fronts)
    assert _equal(out[1].fronts, out[0].fronts)
    rep = out[1].executor
    assert rep["executor"] == "fused" and rep["graphs"] == 1
    assert rep["replays"] == 2 and rep["capture_s"] > 0
    with pytest.raises(ValueError):
        factor.numeric_factorize(plan, bvals, lu.anorm, dtype=dtype,
                                 device=cuda, executor="fused", timings={})


def test_refactor_through_the_replay_leaves_the_old_handle(cuda):
    """refactor on a fused handle replays the plan's graph into a shadow:
    the factors the old handle held (and a copy taken before) are
    untouched by the replay, and the new factors are a fresh stream's."""
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.n_rows))
    _, lu, _, info = slt.gssvx(slt.Options(executor="fused"), a, b,
                               device=cuda)
    assert info == 0 and lu.numeric.executor["executor"] == "fused"
    old = lu.numeric
    saved = [(lp.clone(), up.clone()) for lp, up in old.fronts]
    vals = a.data * (1.0 + 0.05 * np.random.default_rng(0).uniform(
        -1.0, 1.0, a.nnz))
    kernels.reset_launches()
    slt.refactor(lu, vals)
    assert kernels.LAUNCHES["front_assemble"] == len(lu.plan.groups)
    assert lu.numeric is not old and _equal(old.fronts, saved)
    lu2, bvals, _ = slt.analyze(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm), type(a)(
            a.n_rows, a.n_cols, a.indptr, a.indices, vals), device=cuda,
        lu=lu)
    fresh = factor.numeric_factorize(lu.plan, bvals, lu2.anorm,
                                     dtype=lu.numeric.dtype, device=cuda,
                                     executor="stream")
    assert _equal(lu.numeric.fronts, fresh.fronts)


def test_offload_lowers_the_peak_and_solves_on_the_host(cuda):
    """Options(front_bytes_limit=0): every front is copied to pinned host
    memory as it is produced, the peak device memory of the factorization
    is below the stream's, and gssvx solves and refines on the host."""
    a = poisson3d(16)
    b = a.matvec(np.random.default_rng(4).standard_normal(a.n_rows))
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    peaks = {}
    for limit in (6e9, 0):
        # garbage of earlier tests freed inside the window would hide
        # part of this factorization's peak above the base
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        num = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                       dtype=torch.float32, device=cuda,
                                       executor="stream",
                                       front_bytes_limit=limit)
        torch.cuda.synchronize()
        peaks[limit] = torch.cuda.max_memory_allocated() - base
        if limit == 0:
            assert num.on_host and num.offload == "host"
            assert all(lp.device.type == "cpu" and lp.is_pinned()
                       for lp, _ in num.fronts)
            assert _equal(num.fronts, ref)
        else:
            ref = num.fronts
        del num
    assert peaks[0] < peaks[6e9]
    kernels.reset_launches()
    x, luo, st, info = slt.gssvx(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm, front_bytes_limit=0), a, b,
        lu=lu)
    rep = st.solve_report
    assert info == 0 and luo.numeric.on_host and luo.dev_solver is None
    assert rep.solve_route == rep.residual_route == "host"
    assert st.executor["offload"] == "host"
    assert kernels.LAUNCHES["csr_spmv"] == 0
    assert rep.berr <= tols.berr_target(np.float64)


def test_mega_graphs_are_the_closed_keys(cuda):
    """mega on a closed plan: one graph per closed key, the kernel's
    launches counted through the replays (one per group; the warm-up adds
    one per bucket at the first call), factors within the schedule-drift
    gate of the stream in float64 (another cuBLAS algorithm for a padded
    batch may reassociate sums)."""
    a = poisson3d(12)
    lu, bvals, _ = slt.analyze(slt.Options(bucket_closed=True), a,
                               device=cuda)
    plan = lu.plan
    assert plan.closed
    ref = factor.numeric_factorize(plan, bvals, lu.anorm,
                                   dtype=torch.float64, device=cuda,
                                   executor="stream")
    for want in (len(plan.groups) + len(plan.bucket_set), len(plan.groups)):
        kernels.reset_launches()
        num = factor.numeric_factorize(plan, bvals, lu.anorm,
                                       dtype=torch.float64, device=cuda,
                                       executor="mega")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["front_assemble"] == want
        assert _within_drift(num.fronts, ref.fronts)
    assert num.executor["graphs"] == len(plan.bucket_set)


def _normwise(f1, f2):
    num = max(float((x.cpu().double() - y.cpu().double()).abs().max())
              for p, q in zip(f1, f2) for x, y in zip(p, q) if x.numel())
    den = max(float(y.cpu().double().abs().max())
              for q in f2 for y in q if y.numel())
    return num / den


def test_mega_and_the_host_share_in_float32(cuda):
    """float32 at the TF32 tier: mega's factors on a closed plan (padded
    batches) and the host-share split's (the host levels' IEEE float32
    products) within TF32_DRIFT of the stream's, normwise."""
    from superlu_dist_tpu_torch.numeric.plan import bucket_rung
    from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
    a = poisson3d(12)
    for closed in (True, False):
        lu, bvals, _ = slt.analyze(slt.Options(bucket_closed=closed), a,
                                   device=cuda)
        plan = lu.plan
        ref = factor.numeric_factorize(plan, bvals, lu.anorm,
                                       dtype=torch.float32, device=cuda,
                                       executor="stream")
        if closed:
            num = factor.numeric_factorize(plan, bvals, lu.anorm,
                                           dtype=torch.float32, device=cuda,
                                           executor="mega")
            assert num.tiny_pivots == ref.tiny_pivots
            assert _normwise(num.fronts, ref.fronts) <= tols.TF32_DRIFT
            continue
        lv0 = max(bucket_rung(g.batch, lo=1, growth=2.0)
                  * _front_flops(g.w, g.u)
                  for g in plan.groups if g.level == plan.groups[0].level)
        num = factor.numeric_factorize(plan, bvals, lu.anorm,
                                       dtype=torch.float32, device=cuda,
                                       executor="stream",
                                       host_flops=float(lv0) * 1.0001)
        assert num.host_levels >= 1
        assert _normwise(num.fronts, ref.fronts) <= tols.TF32_DRIFT


def test_level_waves_and_the_host_share_on_the_card(cuda):
    """Level waves (one graph per schedule wave) are bit for bit the
    stream; the host-share split (leading levels on the CPU, float64) is
    within the schedule-drift gate of it, and its DeviceSolver uploads the
    host fronts once and solves to the BERR gate."""
    from superlu_dist_tpu_torch.numeric.plan import bucket_rung
    from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
    from superlu_dist_tpu_torch.symbolic.symbfact import _front_flops
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(6).standard_normal(a.n_rows))
    lu, bvals, _ = slt.analyze(slt.Options(), a, device=cuda)
    plan = lu.plan
    ref = factor.numeric_factorize(plan, bvals, lu.anorm,
                                   dtype=torch.float64, device=cuda,
                                   executor="stream")
    thresh = torch.tensor(np.sqrt(np.finfo(np.float64).eps) * lu.anorm)
    ex = StreamExecutor(plan, torch.float64, cuda, granularity="level")
    for _ in range(2):
        fronts, tiny = ex(torch.as_tensor(bvals), thresh)
        assert tiny == ref.tiny_pivots and _equal(fronts, ref.fronts)
    assert ex.report()["graphs"] == len(ex.waves())
    lv0 = max(bucket_rung(g.batch, lo=1, growth=2.0) * _front_flops(g.w, g.u)
              for g in plan.groups if g.level == plan.groups[0].level)
    x, luh, st, info = slt.gssvx(slt.Options(
        fact=slt.Fact.SamePattern_SameRowPerm, factor_dtype="float64",
        host_flops=float(lv0) * 1.0001), a, b, lu=lu)
    num = luh.numeric
    assert info == 0 and num.host_levels >= 1 and not num.on_host
    assert num.fronts[0][0].device.type == "cpu"
    assert num.device.type == "cuda" and _within_drift(num.fronts, ref.fronts)
    assert luh.dev_solver.memory_stats()["uploaded_front_bytes"] > 0
    assert st.solve_report.solve_route == "device"
    assert st.solve_report.berr <= tols.berr_target(np.float64)


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------

def _bundle(a, path):
    x, lu, st, info = slt.gssvx(
        slt.Options(iter_refine=slt.IterRefine.NOREFINE), a,
        np.ones(a.n_rows), device="cuda")
    assert info == 0
    slt.save_lu(lu, str(path))
    return str(path)


def test_thread_replicas_concurrent_with_scrub_and_swap(cuda, tmp_path):
    """Two ThreadReplicas, each holding its own handle, serve concurrent
    traffic at first-use buckets (every ticket captures or replays its
    bucket's sweep graphs on its replica's dispatcher thread) while a
    scrub copies every front of both handles to the host and a rolling
    deploy swaps in a bundle of the same factors: no ticket errs, and
    every X is bit for bit the single-threaded solve of the same columns
    at the same width."""
    import threading
    from superlu_dist_tpu_torch.serve import FleetRouter
    from superlu_dist_tpu_torch.serve.fleet import FLEET_SERVER_KW
    mats = {"p24": poisson3d(24), "p20": poisson3d(20)}
    paths = {k: _bundle(a, tmp_path / k) for k, a in mats.items()}
    same = str(tmp_path / "p24_again")
    import shutil
    shutil.copytree(paths["p24"], same)
    rng = np.random.default_rng(7)
    widths = [1, 2, 3, 5, 8, 13, 16, 7, 1, 4]
    work = [(k, rng.standard_normal((mats[k].n_rows, w)))
            for w in widths for k in ("p24", "p20")]
    # single-threaded references, one fresh handle per key
    refs = {k: slt.load_lu(p) for k, p in paths.items()}
    want = [refs[k].solve_factored(b) for k, b in work]
    fleet = FleetRouter(paths, n_replicas=2, kind="thread", device="cuda",
                        server_kw=dict(FLEET_SERVER_KW))
    errs, got = [], [None] * len(work)
    try:
        # one key per replica: the first ticket of each key fixes it
        for i in (0, 1):
            got[i] = fleet.solve(work[i][0], work[i][1], timeout=300)

        def client(idx):
            try:
                for i in idx:
                    got[i] = fleet.solve(work[i][0], work[i][1],
                                         timeout=300)
            except Exception as e:          # noqa: BLE001
                errs.append(e)

        def scrubber():
            try:
                for r in fleet._replicas:
                    for key in r._cache.resident():
                        assert r._cache.get(key).scrub_now() == []
            except Exception as e:          # noqa: BLE001
                errs.append(e)

        rest = list(range(2, len(work)))
        th = [threading.Thread(target=client, args=(rest[j::3],))
              for j in range(3)]
        th.append(threading.Thread(target=scrubber))
        th.append(threading.Thread(
            target=lambda: fleet.deploy(same, key="p24")))
        for t in th:
            t.start()
        for t in th:
            t.join(600)
        assert not errs, errs
        assert fleet.stats()["errors"] == 0
        assert fleet.stats()["deploys"] == 1
        for i, (w, g) in enumerate(zip(want, got)):
            assert g is not None and np.array_equal(w, g), i
    finally:
        fleet.close()


def test_process_replica_killed_on_the_card_fails_over_bitwise(cuda,
                                                               tmp_path,
                                                               monkeypatch):
    from superlu_dist_tpu_torch.serve import FleetRouter
    a = poisson3d(16)
    path = _bundle(a, tmp_path / "p16")
    ref = slt.load_lu(path)
    rng = np.random.default_rng(8)
    bs = [rng.standard_normal(a.n_rows) for _ in range(6)]
    want = [ref.solve_factored(b) for b in bs]
    monkeypatch.setenv("SLU_TPU_CHAOS", "kill_replica=1@batch=1")
    fleet = FleetRouter({"p16": path}, n_replicas=2, kind="process",
                        device="cuda")
    try:
        assert all(r.device.type == "cuda" for r in fleet._replicas)
        got = [t.result(300) for t in [fleet.submit("p16", b) for b in bs]]
        st = fleet.stats()
        assert st["errors"] == 0 and st["delivered"] == 6
        assert st["failovers"] >= 1 and st["replicas_failed"] == [1]
        for w, g in zip(want, got):
            assert np.array_equal(w, g)
    finally:
        fleet.close(timeout=30)
    assert not any(r._proc.is_alive() for r in fleet._replicas)


def test_poison_isolation_bitwise_at_bucket_16(cuda):
    from superlu_dist_tpu_torch.serve import SolveServer
    from superlu_dist_tpu_torch.utils.errors import ServePoisonedError
    a = poisson3d(20)
    x, lu, st, info = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                                device="cuda")
    rng = np.random.default_rng(9)
    bs = a.matvec(rng.standard_normal((a.n_rows, 16)))
    clean = lu.solve_factored(bs)             # one batch of width 16
    bp = bs.copy()
    bp[:, 11] = np.nan
    srv = SolveServer(lu, start=False)
    tickets = [srv.submit(bp[:, j]) for j in range(16)]
    srv.start()
    srv.flush()
    for j, t in enumerate(tickets):
        if j == 11:
            with pytest.raises(ServePoisonedError) as ei:
                t.result(120)
            assert ei.value.columns == [0] and ei.value.batch_columns == 16
        else:
            assert np.array_equal(t.result(120), clean[:, j]), j
    assert srv.stats()["batches"] == 1
    assert lu.dev_solver.last_solve_stats["padded_nrhs"] == 16
    srv.close()


def test_pgssvx_root_on_the_card_with_a_spawned_cpu_peer(cuda, monkeypatch):
    """The distributed driver with rank 0 on the card and one spawned CPU
    peer at poisson3d(12): both ranks get the same x, within
    DEVICE_VS_HOST of a run whose root factors on the CPU (float64 there,
    float32 at the default tier on the card, both refined to BERR ≤
    berr_target(float64)), and the peer never creates a CUDA context."""
    import os
    from superlu_dist_tpu_torch.parallel.recover import (RowBlockSource,
                                                         VectorBlockSource)
    from superlu_dist_tpu_torch.testing.ranks import (RankJob, collect,
                                                      run_job, spawn_peers,
                                                      stop_peers)
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", "2.0")
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(0).standard_normal(a.n_rows))
    target = float(tols.berr_target(np.float64))
    xs = {}
    for device in ("cpu", "cuda"):
        job = RankJob("pgssvx", f"/slt_cuda_pgx_{device}_{os.getpid()}", 2,
                      slt.Options(), RowBlockSource(a), VectorBlockSource(b),
                      max_len=a.n_rows)
        kernels.reset_launches()
        procs, results, _ = spawn_peers({1: [job]})
        try:
            rec0 = run_job(job, 0, device)
            recs = collect(results, 2, 300, procs)
        finally:
            assert stop_peers(procs) == {1: 0}
        assert "error" not in rec0 and rec0["info"] == 0, rec0.get("error")
        assert rec0["lu_out"]["solve_report"].berr <= target
        peer = [r for r in recs if not r.get("done")][0]
        done = [r for r in recs if r.get("done")][0]
        assert np.array_equal(peer["x"], rec0["x"])
        assert not done["cuda_initialized"]
        groups = len(rec0["lu_out"]["lu"].plan.groups)
        want = groups if device == "cuda" else 0
        assert kernels.LAUNCHES["front_assemble"] == want
        assert kernels.LAUNCHES["csr_spmv"] == 0
        xs[device] = rec0["x"]
    np.testing.assert_allclose(xs["cuda"], xs["cpu"],
                               rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)


def test_mesh_pgssvx_two_ranks_on_one_card(cuda):
    """pgssvx(grid=) with both ranks of a 1×2 grid on the one card (gloo,
    the gathers staged through host memory): the same x on both ranks,
    within DEVICE_VS_HOST of the single-process CPU gssvx, BERR at the
    float64 target, FACTORED on the sharded handles, each rank holding
    only its own slots."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    spec = ("poisson3d", (12,), 0, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec, {}, "root",
                         device="cuda", timeout=600)
    a, b = cases._system(spec)
    x_cpu, _, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    for r in range(2):
        rec = out[r]
        assert rec["info"] == 0 and rec["sharded"]
        assert rec["route"] == "device"
        assert rec["berr"] <= float(tols.berr_target(np.float64))
        assert rec["shard"]["own_slots_only"]
        np.testing.assert_array_equal(rec["x"], out[0]["x"])
        np.testing.assert_allclose(rec["x"], x_cpu,
                                   rtol=tols.DEVICE_VS_HOST_RTOL,
                                   atol=tols.DEVICE_VS_HOST_ATOL)
        assert rec["timings"]["peak_bytes"] > 0


def test_sharded_spmv_on_the_card_equals_the_cpu_grid(cuda):
    """The mesh refinement's residual operator with both ranks of a 1×2
    grid on the card: every product (NOTRANS, TRANS, CONJ, and |op(A)|)
    bit for bit the same grid's on the CPU (csr_spmv equals its plain
    twin, and two ranks' sums add alike)."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    specs = [("convection_diffusion_2d", (30,), 0, None),
             ("helmholtz_2d", (20,), 0, None)]
    rng = np.random.default_rng(8)
    xs = []
    for spec in specs:
        a, _ = cases._system(spec)
        x = rng.standard_normal((a.n_rows, 1))
        xs.append(x + 1j * x[::-1] if np.iscomplexobj(a.data) else x)
    card = run_mesh_ranks(2, cases.sharded_spmv_ops, specs, xs,
                          device="cuda", timeout=600)
    cpu = run_mesh_ranks(2, cases.sharded_spmv_ops, specs, xs, timeout=300)
    for name, _, _, _ in specs:
        for key, y in cpu[0][name].items():
            for r in range(2):
                np.testing.assert_array_equal(card[r][name][key], y)


def test_mesh_fronts_on_the_card_within_tf32_drift(cuda):
    """The spmd fronts on the card, gathered to slot order, equal the
    stream's bit for bit or lie within TF32_DRIFT (cuBLAS may take
    another algorithm for a batch of B_loc slots), with one
    front_assemble launch per group where the rank owns a slot."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    out = run_mesh_ranks(2, cases.spmd_drift_on_the_card,
                         ("poisson3d", (14,), 0, None), device="cuda",
                         timeout=600)
    for r in range(2):
        rec = out[r]
        assert rec["equal"] or rec["drift"] <= tols.TF32_DRIFT, rec
        assert rec["launches"] == rec["owned_groups"]
        assert rec["tiny"][0] == rec["tiny"][1]
        assert rec["shard"]["own_slots_only"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("partition", [False, True])
def test_front_assemble_column_share_equals_plain(cuda, dtype, partition):
    """Every group's column share of every process column of 1×2 and 1×3
    grids (parallel/layout2d.py), reading the replicated pool or the
    rank's compacted one: the kernel's (c, m, mc) fronts equal the plain
    version's bit for bit, one launch per share."""
    from superlu_dist_tpu_torch.parallel.layout2d import layout
    from superlu_dist_tpu_torch.parallel.mesh_stream import share_maps
    rng = np.random.default_rng(5)
    lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(14), device=cuda)
    plan = lu.plan
    avals = _rand(rng, len(bvals), dtype, cuda)
    kernels.reset_launches()
    n = 0
    for npcol in (2, 3):
        for pcol in range(npcol):
            lay = layout(plan, 1, npcol, pcol, partition)
            pool = _rand(rng, lay.pool_len, dtype, cuda)
            for g, gl in zip(plan.groups, lay.groups):
                if not (len(gl.slots) and gl.mc):
                    continue
                gm = share_maps(gl, cuda)
                a = kernels.front_assemble_(avals, pool, g.m, g.w, gm)
                b = kernels.front_assemble_plain(avals, pool, g.m, g.w, gm)
                assert a.shape == (len(gl.slots), g.m * gl.mc)
                assert torch.equal(a, b)
                n += 1
    assert kernels.LAUNCHES["front_assemble"] == n > 0


@pytest.mark.parametrize("partition", [False, True])
def test_mesh2d_fronts_on_the_card_within_tf32_drift(cuda, partition):
    """The 2-D mesh stream on a 1×2 grid, both ranks on the one card over
    gloo, float32 at the default TF32 tier: the fronts gathered to slot
    order equal the stream's on the card or lie within TF32_DRIFT, the
    tiny count is the stream's, one front_assemble launch per group where
    the rank assembles, each rank holding only its own slots and
    columns."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    out = run_mesh_ranks(2, cases.mesh2d_drift_on_the_card,
                         ("poisson3d", (14,), 0, None), partition,
                         device="cuda", timeout=600)
    for r in range(2):
        rec = out[r]
        assert rec["equal"] or rec["drift"] <= tols.TF32_DRIFT, rec
        assert rec["launches"] == rec["owned_groups"]
        assert rec["tiny"][0] == rec["tiny"][1]
        assert rec["shard"]["own_slots_only"] and rec["shard"]["own_cols_only"]
        assert rec["executor"]["executor"] == "mesh-stream"


def test_mesh2d_pgssvx_two_ranks_on_one_card(cuda):
    """pgssvx(grid=gridinit(1, 2), Options(executor="stream",
    pool_partition=True)) with both ranks on the one card: the same x on
    both ranks, within DEVICE_VS_HOST of the CPU gssvx, BERR at the
    float64 target, FACTORED and the SamePattern refactor on the 2-D
    handles, each rank's pool below the plan's."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    spec = ("poisson3d", (12,), 0, None)
    out = run_mesh_ranks(2, cases.pgssvx_flow, spec,
                         {"executor": "stream", "pool_partition": True},
                         "root", device="cuda", timeout=600)
    a, b = cases._system(spec)
    x_cpu, _, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
    for r in range(2):
        rec = out[r]
        assert rec["info"] == 0 and rec["sharded"]
        assert rec["route"] == "device"
        assert rec["berr"] <= float(tols.berr_target(np.float64))
        assert rec["shard"]["own_slots_only"] and rec["shard"]["own_cols_only"]
        np.testing.assert_array_equal(rec["x"], out[0]["x"])
        np.testing.assert_allclose(rec["x"], x_cpu,
                                   rtol=tols.DEVICE_VS_HOST_RTOL,
                                   atol=tols.DEVICE_VS_HOST_ATOL)
        t = rec["timings"]
        assert t["bcasts"] > 0 and t["exchange_bytes"] > 0
    assert sum(out[r]["timings"]["pool_bytes"] for r in range(2)) \
        < 2 * out[0]["pool_size_bytes"]


@pytest.mark.parametrize("executor", ["fused", "mega"])
def test_grid_graphs_capture_and_replay_on_one_card(cuda, executor):
    """Options(executor="fused"/"mega") on a 1×2 grid, both ranks on the
    one card over gloo, float32 at the default tier: the segment graphs
    captured at the first call and replayed by two more, the replays'
    fronts bit for bit equal, the first call's the 2-D stream's or within
    TF32_DRIFT, one front_assemble launch per group where the rank
    assembles at every call (inside the graphs), and at the first call
    also one per warmed-up group shape."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    out = run_mesh_ranks(2, cases.grid_graphs_on_the_card,
                         ("poisson3d", (14,), 0, None), executor,
                         device="cuda", timeout=900)
    for r in range(2):
        rec = out[r]
        assert rec["replays_equal"] and rec["first_equals_replay"], rec
        assert rec["equal"] or rec["drift"] <= tols.TF32_DRIFT, rec
        assert len(set(rec["tiny"])) == 1, rec["tiny"]
        ex = rec["executor"]
        assert ex["executor"] == "mesh-" + executor
        assert ex["segments"] > 0 and ex["replays"] >= 2 * ex["segments"]
        warm = rec["warm_up_launches"]
        assert 0 < warm <= rec["owned_groups"]
        assert rec["launches"] == [rec["owned_groups"] + warm,
                                   rec["owned_groups"],
                                   rec["owned_groups"]]


def test_offloaded_grid_factors_lie_in_pinned_host_memory(cuda):
    """front_bytes_limit=0 on a 1×2 grid on one card: every rank's fronts
    and pivot stacks in pinned host memory, bit for bit the non-offloaded
    run's, a lower device peak, and the solve in host memory within
    TF32_DRIFT (normwise) of the device factors' solve, whose GEMMs run at
    the TF32 tier."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    out = run_mesh_ranks(2, cases.grid_offload_on_the_card,
                         ("poisson3d", (14,), 0, None), device="cuda",
                         timeout=600)
    for r in range(2):
        rec = out[r]
        assert rec["on_host"] and rec["pinned"] and rec["pivots_pinned"]
        assert rec["equal"], r
        assert rec["peaks"][1] < rec["peaks"][0], rec["peaks"]
        assert rec["solver_device"] == "cpu"
        assert rec["x_rel"] <= tols.TF32_DRIFT, rec["x_rel"]
        assert rec["executor"]["offload"] == "host"


# ---- the reference's user entry points on the card --------------------------

def _capi_client(*args, metrics=None):
    import os
    from superlu_dist_tpu_torch.bindings import build
    lib, exe = build.build()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if metrics is not None:
        env["SLU_TPU_METRICS"] = str(metrics)
    return subprocess.run([str(exe), *map(str, args)], capture_output=True,
                          text=True, env=env, timeout=600,
                          stdin=subprocess.DEVNULL)


def test_capi_client_on_the_card(cuda, tmp_path):
    """The C client with slu_tpu_init(NULL) (the card): poisson3d(12)
    built in C, DOFACT, FACTORED at nrhs 1 and 4, a tier-2 refactor; x
    within DEVICE_VS_HOST of the in-process gssvx on the card, one
    front_assemble launch per group for its DOFACT (its metrics export),
    exit 0 after slu_tpu_finalize; and the tridiagonal self-check."""
    import json
    out, metrics = tmp_path / "x.bin", tmp_path / "m.json"
    res = _capi_client("default", 12, out, metrics=metrics)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "C API poisson3d(12) PASS" in res.stdout
    raw = out.read_bytes()
    n = int(np.frombuffer(raw[:8], dtype=np.int64)[0])
    b = np.frombuffer(raw[8:8 + 8 * n], dtype=np.float64)
    x = np.frombuffer(raw[8 + 8 * n:], dtype=np.float64)
    a = poisson3d(12)
    x_ref, lu, _, info = slt.gssvx(slt.Options(), a, b, device="cuda")
    assert info == 0
    np.testing.assert_allclose(x, x_ref, rtol=tols.DEVICE_VS_HOST_RTOL,
                               atol=tols.DEVICE_VS_HOST_ATOL)
    counters = json.loads(metrics.read_text())["counters"]
    key = ('slu_capi_kernel_launches_total{call="factor_opts",'
           f'kernel="front_assemble",n="{n}"}}')
    assert counters[key] == len(lu.plan.groups)
    res = _capi_client("default")
    assert res.returncode == 0 and "C API PASS" in res.stdout, res.stdout


def test_fortran_driver_on_the_card(cuda, tmp_path):
    """f_pddrive.f90 over superlu_mod.f90 and libslu_tpu_torch.so, on the
    card; compiled where gfortran exists."""
    import os
    import shutil
    from superlu_dist_tpu_torch.bindings import build
    gfortran = shutil.which("gfortran")
    if gfortran is None:
        pytest.skip("no gfortran on this machine")
    lib, _ = build.build()
    here = ROOT / "superlu_dist_tpu_torch" / "bindings"
    exe = tmp_path / "f_pddrive"
    r = subprocess.run([gfortran, "-o", str(exe), str(here / "superlu_mod.f90"),
                        str(here / "f_pddrive.f90"), "-J", str(tmp_path),
                        *build.link_flags(lib)], capture_output=True,
                       text=True, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=600, stdin=subprocess.DEVNULL)
    assert r.returncode == 0 and "PASS" in r.stdout, (r.stdout, r.stderr)


EXAMPLES = ["pddrive", "pddrive1", "pddrive2", "pddrive3", "pddrive4",
            "pzdrive", "pzdrive1", "pzdrive2", "pzdrive3", "pzdrive4",
            "pddrive_ABglobal", "pddrive_dist", "pddrive_df64",
            "pddrive_refactor"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_on_the_card(cuda, name, capsys):
    import importlib
    mod = importlib.import_module(f"superlu_dist_tpu_torch.examples.{name}")
    kernels.reset_launches()
    assert mod.main(["--device", "cuda"]) == 0
    assert "residual" in capsys.readouterr().out
    assert kernels.LAUNCHES["front_assemble"] > 0


@pytest.mark.parametrize("name", ["pddrive4", "pzdrive4"])
def test_subgrid_examples_with_four_ranks_on_the_card(cuda, name, capsys):
    import importlib
    mod = importlib.import_module(f"superlu_dist_tpu_torch.examples.{name}")
    assert mod.main(["--device", "cuda", "--nproc", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[{name} grid=(2, 1) ranks=[2, 3] seed=1] residual" in out


def test_subgrids_four_ranks_share_the_card(cuda):
    """gridmap's two 2×1 sub-grids with four ranks on the one card (gloo):
    each sub-grid's x bit for bit the other sub-grid's solve of the same
    system alone, the same verified collectives, within DEVICE_VS_HOST of
    the CPU gssvx."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    specs = [("poisson3d", (8,), 1, None), ("poisson3d", (9,), 2, None)]
    out = run_mesh_ranks(4, cases.subgrids, specs, device="cuda",
                         timeout=600,
                         env={"SLU_TPU_VERIFY_COLLECTIVES": "1"})
    np.testing.assert_array_equal(out[0]["x_alone"], out[2]["x"])
    assert out[0]["seq_alone"] == out[2]["seq"]
    for which in (0, 1):
        a, b = cases._system(specs[which])
        x_cpu, _, _, _ = slt.gssvx(slt.Options(), a, b, device="cpu")
        np.testing.assert_allclose(out[2 * which]["x"], x_cpu,
                                   rtol=tols.DEVICE_VS_HOST_RTOL,
                                   atol=tols.DEVICE_VS_HOST_ATOL)


def test_pdtest_quick_on_the_card(cuda, capsys):
    """pdtest --quick on the card: 1x1 in this process, 1x2 with both
    ranks on the card; every run passes."""
    from superlu_dist_tpu_torch.examples import pdtest
    assert pdtest.main(["--quick", "--device", "cuda"]) == 0
    assert "passed the threshold (    48 tests run)" in \
        capsys.readouterr().out


@pytest.mark.parametrize("cplx", [False, True])
def test_df64_on_the_card_is_float64_bit_for_bit(cuda, cplx):
    a = helmholtz_2d(20) if cplx else poisson3d(10)
    b = a.matvec(np.ones(a.n_rows))
    got = {}
    for dt in ("df64", "float64"):
        x, lu, st, info = slt.gssvx(slt.Options(factor_dtype=dt), a, b,
                                    device="cuda")
        assert info == 0
        got[dt] = (x, lu.numeric.dtype, st.solve_report.factor_dtype)
    assert got["df64"][1] == got["float64"][1] == (
        torch.complex128 if cplx else torch.float64)
    assert got["df64"][2] == got["float64"][2]
    np.testing.assert_array_equal(got["df64"][0], got["float64"][0])


# ---------------------------------------------------------------------------
# kernel spans and granularity="level" on the grid, on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["stream", "level", "fused", "mega"])
def test_kernel_spans_on_the_card(cuda, tmp_path, executor):
    """A FACT of poisson3d(12) (float32, the default tier) under a file
    Tracer against an untraced one: the fronts bit for bit, no more
    synchronize calls, the same launches, a kernel span a group (a wave
    at "level", one factor-fused), each with a positive device time,
    last_profile one entry a span."""
    import json
    from superlu_dist_tpu_torch.numeric.fused import FusedExecutor
    from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
    from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
    from superlu_dist_tpu_torch.obs import trace
    lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(12), device=cuda)
    plan = lu.plan
    ex = {"stream": lambda: StreamExecutor(plan, torch.float32, cuda),
          "level": lambda: StreamExecutor(plan, torch.float32, cuda,
                                          granularity="level"),
          "fused": lambda: FusedExecutor(plan, torch.float32, cuda),
          "mega": lambda: MegaExecutor(plan, torch.float32, cuda)}[executor]()
    thresh = torch.tensor(np.sqrt(np.finfo(np.float32).eps) * lu.anorm,
                          dtype=torch.float32)
    avals = torch.as_tensor(bvals)
    ex(avals, thresh)                      # the graphs' capture
    calls = []
    real_sync = torch.cuda.synchronize

    def run(path=None):
        tracer = trace.Tracer(path) if path else None
        prev = trace.install(tracer) if tracer else None
        torch.cuda.synchronize = lambda *a: (calls.append(path),
                                             real_sync(*a))[1]
        kernels.reset_launches()
        try:
            out = ex(avals, thresh)
        finally:
            torch.cuda.synchronize = real_sync
            if tracer:
                trace.install(prev)
                tracer.close()
        real_sync()
        return out, dict(kernels.LAUNCHES)
    (plain, _), plain_l = run()
    (traced, _), traced_l = run(str(tmp_path / "t.json"))
    assert _equal(traced, plain) and traced_l == plain_l
    untraced_syncs = calls.count(None)
    assert len(calls) - untraced_syncs <= untraced_syncs
    events = json.load(open(tmp_path / "t.json"))["traceEvents"]
    spans = [e for e in events if e["cat"] == "kernel"]
    want = {"stream": len(plan.groups), "mega": len(plan.groups),
            "level": len(ex.waves()), "fused": 1}[executor]
    assert len(spans) == want == len(ex.last_profile)
    assert all(e["dur"] > 0 for e in spans)
    if executor == "fused":
        assert spans[0]["name"] == "factor-fused"
    else:
        assert all(e["args"]["aggregate"] == (executor == "level")
                   for e in spans)


def test_grid_level_and_spans_on_one_card(cuda, tmp_path):
    """MeshStreamExecutor(granularity="level") on a 1×2 grid, both ranks
    on the one card over gloo (float64): each rank's fronts and pivot
    stacks bit for bit those of "group"; and every grid executor traced
    on the card: a span a group (a wave at "level") with a positive
    device time, the traced fronts bit for bit the untraced ones."""
    import torch_mesh_cases as cases
    from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks
    lu, bvals, _ = slt.analyze(slt.Options(), poisson3d(10), device="cpu")
    thresh = float(np.sqrt(np.finfo(np.float64).eps) * lu.anorm)
    out = run_mesh_ranks(2, cases.level_vs_group, lu.plan, bvals, thresh,
                         True, device="cuda", timeout=900)
    for r in range(2):
        assert out[r]["equal"] and out[r]["pivots_equal"], out[r]
        assert out[r]["units"] < out[r]["groups"]
    spans = run_mesh_ranks(2, cases.traced_grid_spans, lu.plan, bvals,
                           thresh, str(tmp_path / "g"), device="cuda",
                           timeout=900)
    for r in range(2):
        for name, rec in spans[r].items():
            lu_spans = [d for n, d, _ in rec["kernel"] if n.startswith("lu ")]
            assert rec["equal"], (r, name)
            assert all(d > 0 for _, d, _ in rec["kernel"]), (r, name)
            if name == "spmd":
                continue
            want = rec["units"]
            assert len(lu_spans) == want == len(rec["profile"]), (r, name)
