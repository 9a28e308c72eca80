"""The distributed analysis of the mesh tier
(superlu_dist_tpu_torch/parallel/panalysis.py, ParSymbFact) against the
JAX package's ``parallel/panalysis.py``, array for array on the same
inputs: the coarse bisection (``_coarse_bisect``), the bordered
supernodal symbolic (``_bordered_symbolic``, empty and non-empty
borders), the fine-level separator trimming (``_trim_separators``, on one
rank and on two thread ranks of each package's TreeComm), the
distributed equilibration, and the whole ``panalyze`` on two and three
thread ranks (permutation, supernodes, permuted values, plan).
"""

import os

import numpy as np
import pytest

from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel import panalysis as jpan
from superlu_dist_tpu.parallel import treecomm as jtreecomm
from superlu_dist_tpu.sparse.formats import coo_to_csr as jcoo_to_csr
from superlu_dist_tpu.sparse.formats import symmetrize_pattern as jsym
from superlu_dist_tpu.utils.options import Options as JOptions
from superlu_dist_tpu.utils.options import RowPerm as JRowPerm

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.parallel import panalysis as pan
from superlu_dist_tpu_torch.parallel.dist import distribute_rows
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.testing.ranks import run_thread_ranks
from superlu_dist_tpu_torch.utils.options import RowPerm

_SEQ = [0]


class _LoneTree:
    """Single-rank stand-in for a TreeComm: allreduce is identity."""
    n_ranks = 1
    rank = 0

    def allreduce_sum_any(self, arr, root=0):
        return arr


def _thread_ranks(n, fn, jax=False):
    _SEQ[0] += 1
    classes = {r: jtreecomm.TreeComm for r in range(n)} if jax else None
    out = run_thread_ranks(f"/slt_pan_{os.getpid()}_{_SEQ[0]}", n, fn,
                           max_len=1 << 14, classes=classes, timeout=120)
    for r, v in out.items():
        if isinstance(v, Exception):
            raise v
    return out


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _graph(make):
    s = jsym(make(jgal))
    return s.n_rows, np.asarray(s.indptr), np.asarray(s.indices)


# ---------------------------------------------------------------------------
# coarse bisection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nparts", [2, 3, 4, 5])
@pytest.mark.parametrize("which", ["poisson2d", "poisson3d", "convdiff"])
def test_coarse_bisect_equals_jax(which, nparts):
    make = {"poisson2d": lambda g: g.poisson2d(20),
            "poisson3d": lambda g: g.poisson3d(7),
            "convdiff": lambda g: g.convection_diffusion_2d(17)}[which]
    n, ip, ix = _graph(make)
    w = np.random.default_rng(nparts).integers(1, 4, size=n).astype(float)
    _equal(pan._coarse_bisect(n, ip, ix, w, nparts),
           jpan._coarse_bisect(n, ip, ix, w, nparts))


def test_coarse_bisect_disconnected_equals_jax():
    # two components of weights 30 and 10 on three ranks
    rows = np.r_[np.arange(29), np.arange(30, 39)]
    g = jcoo_to_csr(40, 40, np.r_[rows, rows + 1], np.r_[rows + 1, rows],
                    np.ones(2 * len(rows)))
    w = np.ones(40)
    _equal(pan._coarse_bisect(40, g.indptr, g.indices, w, 3),
           jpan._coarse_bisect(40, g.indptr, g.indices, w, 3))


# ---------------------------------------------------------------------------
# bordered symbolic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("border", [0, 7, 30])
@pytest.mark.parametrize("relax,nsup", [(8, 64), (1, 16)])
def test_bordered_symbolic_equals_jax(border, relax, nsup):
    n, ip, ix = _graph(lambda g: g.poisson2d(12))
    m = n - border
    _equal(pan._bordered_symbolic(m, n, ip, ix, relax, nsup),
           jpan._bordered_symbolic(m, n, ip, ix, relax, nsup))


@pytest.mark.parametrize("border", [0, 11])
def test_bordered_symbolic_python_twins_match_the_fill(border):
    n, ip, ix = _graph(lambda g: g.poisson2d(10))
    m = n - border
    nat = pan._bordered_symbolic(m, n, ip, ix, 8, 64)
    py = pan._bordered_symbolic(m, n, ip, ix, 8, 64, native=False)

    def fill(out):
        w = np.diff(out[1])
        us = np.array([len(r) for r in out[2]])
        return int(np.sum(w * (w + 1) // 2) + np.sum(w * us))
    assert fill(nat) == fill(py)
    assert len(py[0]) == m and py[1][-1] == m


# ---------------------------------------------------------------------------
# separator trimming
# ---------------------------------------------------------------------------

def _path_slab():
    n = 20
    lab = np.array([0] * 9 + [-1, -1, -1] + [1] * 8, dtype=np.int64)
    sr = np.repeat(np.arange(n), 2)[1:-1]
    sc = np.empty_like(sr)
    sc[0::2] = sr[0::2] + 1
    sc[1::2] = sr[1::2] - 1
    return n, lab, sr, sc, {0: [0], 1: [0]}, 2


def _grid_slab():
    """poisson2d(16) cut into 2 parts by a 3-column separator slab."""
    a = jsym(jgal.poisson2d(16))
    n = a.n_rows
    col = np.arange(n) % 16
    lab = np.where(col < 7, 0, np.where(col > 9, 1, -1)).astype(np.int64)
    sr = np.repeat(np.arange(n), np.diff(a.indptr))
    return n, lab, sr, np.asarray(a.indices), {0: [0], 1: [0]}, 2


@pytest.mark.parametrize("case", ["path", "grid"])
def test_trim_separators_equals_jax(case):
    n, lab, sr, sc, anc, P = {"path": _path_slab, "grid": _grid_slab}[case]()
    mine = pan._trim_separators(_LoneTree(), lab.copy(), sr, sc, 0, n, anc,
                                P)
    ref = jpan._trim_separators(_LoneTree(), lab.copy(), sr, sc, 0, n, anc,
                                P)
    np.testing.assert_array_equal(mine, ref)
    assert (mine < 0).sum() < (lab < 0).sum()


@pytest.mark.parametrize("case", ["path", "grid"])
def test_trim_separators_on_two_ranks_equals_jax(case):
    n, lab, sr, sc, anc, P = {"path": _path_slab, "grid": _grid_slab}[case]()
    half = n // 2

    def make(mod):
        def fn(tc):
            lo, hi = (0, half) if tc.rank == 0 else (half, n)
            own = (sr >= lo) & (sr < hi)
            return mod._trim_separators(tc, lab.copy(), sr[own], sc[own],
                                        lo, hi, anc, P)
        return fn
    mine = _thread_ranks(2, make(pan))
    ref = _thread_ranks(2, make(jpan), jax=True)
    for r in range(2):
        np.testing.assert_array_equal(mine[r], ref[r])
    np.testing.assert_array_equal(mine[0], mine[1])


# ---------------------------------------------------------------------------
# distributed equilibration and the whole analysis
# ---------------------------------------------------------------------------

def test_pgsequ_equals_jax():
    a = gallery.convection_diffusion_2d(12)
    ja = jgal.convection_diffusion_2d(12)
    part = distribute_rows(a, 1)[0]
    from superlu_dist_tpu.parallel.dist import distribute_rows as jdist
    jpart = jdist(ja, 1)[0]
    _equal(list(pan._pgsequ(_LoneTree(), part)),
           list(jpan._pgsequ(_LoneTree(), jpart)))


@pytest.mark.parametrize("n_ranks", [2, 3])
@pytest.mark.parametrize("which", ["poisson_norowperm", "convdiff_mc64",
                                   "helmholtz"])
def test_panalyze_equals_jax_on_thread_ranks(which, n_ranks):
    make, kw, jkw = {
        "poisson_norowperm": (lambda g: g.poisson2d(24),
                              {"row_perm": RowPerm.NOROWPERM},
                              {"row_perm": JRowPerm.NOROWPERM}),
        "convdiff_mc64": (lambda g: g.convection_diffusion_2d(20), {}, {}),
        "helmholtz": (lambda g: g.helmholtz_2d(18), {}, {})}[which]
    parts = distribute_rows(make(gallery), n_ranks)
    from superlu_dist_tpu.parallel.dist import distribute_rows as jdist
    jparts = jdist(make(jgal), n_ranks)

    def mine(tc):
        lu, bvals = pan.panalyze(tc, slt.Options(**kw), parts[tc.rank],
                                 device="cpu")
        return lu, bvals

    def ref(tc):
        return jpan.panalyze(tc, JOptions(**jkw), jparts[tc.rank])

    out, jout = _thread_ranks(n_ranks, mine), _thread_ranks(n_ranks, ref,
                                                            jax=True)
    for r in range(n_ranks):
        (lu, bvals), (jlu, jbvals) = out[r], jout[r]
        np.testing.assert_array_equal(lu.sf.perm, jlu.sf.perm)
        np.testing.assert_array_equal(lu.sf.sn_start, jlu.sf.sn_start)
        np.testing.assert_array_equal(lu.row_order, jlu.row_order)
        np.testing.assert_array_equal(bvals, np.asarray(jbvals))
        assert lu.equed == jlu.equed and lu.anorm == jlu.anorm
        assert len(lu.plan.groups) == len(jlu.plan.groups)
        assert lu.plan.pool_size == jlu.plan.pool_size
        assert lu.col_order is None and lu.a is None
