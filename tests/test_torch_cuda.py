"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version (bit for bit), the factorization through the kernels
against the one through the plain versions, and gssvx on the card.

These tests need an NVIDIA GPU and skip without one.  The JAX package is
not installed beside the card, so run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models.gallery import poisson3d, random_sparse
from superlu_dist_tpu_torch.numeric import factor, kernels
from superlu_dist_tpu_torch.utils import tols

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
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
    pool = torch.as_tensor(rng.standard_normal(pool_len), dtype=dtype,
                           device=cuda)
    f = torch.as_tensor(rng.standard_normal((batch, m * m)), dtype=dtype,
                        device=cuda)
    kernels.reset_launches()
    a, b = f.clone(), f.clone()
    kernels.extend_add_(a, pool, m, ub, *args)
    kernels.extend_add_plain(b, pool, m, ub, *args)
    assert kernels.LAUNCHES["extend_add"] == 1
    assert torch.equal(a, b) and not torch.equal(a, f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assemble_kernel_equals_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    batch, m2, n_avals, n = 6, 900, 500, 3000
    tgt = rng.choice(batch * m2, size=n, replace=False)
    slot, flat = tgt // m2, tgt % m2
    slot[:7] = batch                                 # dropped entries
    src = rng.integers(0, n_avals + 20, n)           # some read 0
    idx = [torch.as_tensor(x, device=cuda) for x in (slot, flat, src)]
    avals = torch.as_tensor(rng.standard_normal(n_avals), dtype=dtype,
                            device=cuda)
    f = torch.as_tensor(rng.standard_normal((batch, m2)), dtype=dtype,
                        device=cuda)
    kernels.reset_launches()
    a, b = f.clone(), f.clone()
    kernels.assemble_(a, avals, *idx)
    kernels.assemble_plain(b, avals, *idx)
    assert kernels.LAUNCHES["assemble"] == 1
    assert torch.equal(a, b)


@pytest.mark.parametrize("make", [lambda: poisson3d(10),
                                  lambda: random_sparse(300, 0.02, seed=4)])
def test_factor_through_kernels_equals_plain(cuda, make):
    lu, bvals, _ = slt.analyze(slt.Options(), make(), device=cuda)
    fk = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                  dtype=torch.float32, device=cuda)
    fp = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                  dtype=torch.float32, device=cuda,
                                  scatter=factor.PLAIN)
    for (lk, uk), (lp, up) in zip(fk.fronts, fp.fronts):
        assert torch.equal(lk, lp) and torch.equal(uk, up)


def test_gssvx_on_the_card(cuda):
    a = poisson3d(12)
    b = a.matvec(np.random.default_rng(2).standard_normal(a.n_rows))
    kernels.reset_launches()
    x, lu, _, info = slt.gssvx(slt.Options(), a, b)
    assert info == 0 and lu.numeric.dtype == torch.float32
    assert lu.numeric.device.type == "cuda"
    assert min(kernels.LAUNCHES.values()) > 0
    assert lu.berrs[-1] <= tols.berr_target(np.float64)
