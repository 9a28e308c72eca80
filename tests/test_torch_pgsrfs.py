"""Distributed refinement (superlu_dist_tpu_torch/parallel/pgsrfs.py, the
pdgsrfs/pdgsmv analog) on the CPU: the port's pgsrfs against the JAX
package's on the same rows, x0 and correction solve (bit for bit: both
are the same numpy arithmetic over the same tree collectives); the port
at four thread ranks bit for bit its single rank at NOTRANS, within
DEVICE_VS_HOST at TRANS (the transposed residual adds the ranks' partial
sums in tree order); and under the fault-injection wrapper."""

import os

import numpy as np
import pytest

from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel import dist as jdist
from superlu_dist_tpu.parallel import pgsrfs as jpgsrfs
from superlu_dist_tpu.parallel import treecomm as jtreecomm

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.parallel.dist import distribute_rows
from superlu_dist_tpu_torch.parallel.pgsrfs import pgsrfs
from superlu_dist_tpu_torch.parallel.treecomm import (FaultyTreeComm,
                                                      TreeComm,
                                                      parse_fault_spec)
from superlu_dist_tpu_torch.testing.ranks import run_thread_ranks
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.options import IterRefine, Trans

_SEQ = [0]


def run_ranks(n_ranks, fn, max_len=64, classes=None):
    _SEQ[0] += 1
    return run_thread_ranks(f"/slt_rfs_{os.getpid()}_{_SEQ[0]}", n_ranks,
                            fn, max_len=max_len, classes=classes)

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL


@pytest.fixture(scope="module")
def coarse():
    """poisson2d(12), b = A·x_true from seed 0, and coarse float32 factors
    on the CPU (NOREFINE), so the distributed refinement has work to do."""
    a = gallery.poisson2d(12)
    b = a.matvec(np.random.default_rng(0).standard_normal(a.n_rows))
    opts = slt.Options(iter_refine=IterRefine.NOREFINE,
                       factor_dtype="float32")
    x0, lu, _, info = slt.gssvx(opts, a, b, device="cpu")
    assert info == 0
    return a, b, x0, lu


def _refine(tc, parts, b, x0, solve_fn, trans=Trans.NOTRANS, jax=False):
    p = parts[tc.rank]
    so = {}
    fn = jpgsrfs.pgsrfs if jax else pgsrfs
    kw = {}
    if trans != Trans.NOTRANS:
        from superlu_dist_tpu.utils.options import Trans as JTrans
        kw["trans"] = JTrans[trans.name] if jax else trans
    x = fn(tc, p, b[p.fst_row:p.fst_row + p.m_loc],
           x0 if tc.rank == 0 else None, solve_fn if tc.rank == 0 else None,
           stats_out=so, **kw)
    return x, so


@pytest.mark.parametrize("trans", [Trans.NOTRANS, Trans.TRANS])
def test_pgsrfs_equals_jax_on_one_rank(coarse, trans):
    a, b, x0, lu = coarse
    solve = (lu.solve_factored if trans == Trans.NOTRANS
             else (lambda r: lu.solve_factored_trans(r)))
    ja = jgal.poisson2d(12)
    got = {}
    for jax, parts, cls in ((False, distribute_rows(a, 1), TreeComm),
                            (True, jdist.distribute_rows(ja, 1),
                             jtreecomm.TreeComm)):
        with cls(f"/slt_rfs1_{os.getpid()}_{int(jax)}", 1, 0,
                 max_len=a.n_rows) as tc:
            got[jax] = _refine(tc, parts, b, x0, solve, trans, jax=jax)
    (x, so), (jx, jso) = got[False], got[True]
    np.testing.assert_array_equal(x, jx)
    assert so == jso and so["berr"] <= tols.berr_target(np.float64)
    assert so["iters"] >= 2


@pytest.mark.parametrize("trans", [Trans.NOTRANS, Trans.TRANS])
def test_four_thread_ranks_against_one(coarse, trans):
    a, b, x0, lu = coarse
    solve = (lu.solve_factored if trans == Trans.NOTRANS
             else (lambda r: lu.solve_factored_trans(r)))
    one = run_ranks(1, lambda tc: _refine(tc, distribute_rows(a, 1), b, x0,
                                          solve, trans), max_len=a.n_rows)
    parts = distribute_rows(a, 4)
    four = run_ranks(4, lambda tc: _refine(tc, parts, b, x0, solve, trans),
                     max_len=40)
    x1, so1 = one[0]
    for r, (x, so) in four.items():
        np.testing.assert_array_equal(x, four[0][0])   # every rank: root's
        assert so["iters"] == four[0][1]["iters"]
    if trans == Trans.NOTRANS:
        # every residual slot has one nonzero contributor: bit for bit
        np.testing.assert_array_equal(four[0][0], x1)
        assert four[0][1] == so1
    else:
        np.testing.assert_allclose(four[0][0], x1, rtol=RTOL, atol=ATOL)
        assert four[0][1]["berr"] <= tols.berr_target(np.float64)


@pytest.mark.faultinject
def test_pgsrfs_under_drop_dup_and_reorder(coarse):
    """Injected chunk faults are masked by retransmission: the same x and
    iteration count as the clean run, bit for bit."""
    a, b, x0, lu = coarse
    parts = distribute_rows(a, 3)
    spec = parse_fault_spec("drop=0.3,dup=0.2,reorder=0.5,seed=7")
    clean = run_ranks(3, lambda tc: _refine(tc, parts, b, x0,
                                            lu.solve_factored), max_len=16)
    faulty = run_ranks(
        3, lambda tc: _refine(tc, parts, b, x0, lu.solve_factored),
        max_len=16, classes={r: (lambda *a_, **k: FaultyTreeComm(
            *a_, **k, **spec)) for r in range(3)})
    for r in range(3):
        np.testing.assert_array_equal(faulty[r][0], clean[r][0])
        assert faulty[r][1] == clean[r][1]
