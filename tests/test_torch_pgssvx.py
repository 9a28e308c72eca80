"""The distributed driver (superlu_dist_tpu_torch/parallel/pgssvx.py, the
pdgssvx-with-NR_loc-input analog) on the CPU.

* Against the JAX package: the same block rows of A and B go through the
  JAX ``pgssvx`` and the port's, each on a single-rank TreeComm in this
  process (nothing forks under JAX), at NOTRANS with nrhs 1 and 3, TRANS,
  complex CONJ, FACTORED reuse and the distributed-hiprec rung.  The two
  factor with different frameworks (factors within SCHEDULE_DRIFT), so
  the refined x are held at DEVICE_VS_HOST and BERR at berr_target(f64).
* The port at several ranks: thread ranks bit for bit one rank at
  NOTRANS (every peer's x the root's); one run of three spawned
  processes at poisson3d(8); a root-side exception raised on every rank
  (bcast_result); the mesh tier's arguments refused where they do not
  fit.
"""

import os

import numpy as np
import pytest
import torch

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.parallel import dist as jdist
from superlu_dist_tpu.parallel import pgssvx as jpgssvx
from superlu_dist_tpu.parallel import treecomm as jtreecomm

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.parallel import pgssvx as pg
from superlu_dist_tpu_torch.parallel.dist import distribute_rows
from superlu_dist_tpu_torch.parallel.recover import (RowBlockSource,
                                                     VectorBlockSource)
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.testing.ranks import (RankJob, collect,
                                                  run_job, run_thread_ranks,
                                                  spawn_peers, stop_peers)
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.errors import SuperLUError

_SEQ = [0]


def run_ranks(n_ranks, fn, max_len=64, classes=None):
    _SEQ[0] += 1
    return run_thread_ranks(f"/slt_pgx_{os.getpid()}_{_SEQ[0]}", n_ranks,
                            fn, max_len=max_len, classes=classes)

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
TARGET = float(tols.berr_target(np.float64))
NEAR_SINGULAR = dict(n=60, delta=1e-6, seed=0)


def _blocks(part, b):
    return b[part.fst_row:part.fst_row + part.m_loc]


def _port_one_rank(opts, a, b, lu=None):
    lu_out = {}
    with TreeComm(f"/slt_pgx1_{os.getpid()}", 1, 0,
                  max_len=max(a.n_rows, 64)) as tc:
        part = distribute_rows(a, 1)[0]
        x, info = pg.pgssvx(tc, opts, part, _blocks(part, b), lu=lu,
                            lu_out=lu_out, device="cpu")
    return x, info, lu_out


def _jax_one_rank(opts, ja, b, lu=None):
    lu_out = {}
    with jtreecomm.TreeComm(f"/slt_jpgx1_{os.getpid()}", 1, 0,
                            max_len=max(ja.n_rows, 64)) as tc:
        part = jdist.distribute_rows(ja, 1)[0]
        x, info = jpgssvx.pgssvx(tc, opts, part, _blocks(part, b), lu=lu,
                                 lu_out=lu_out)
    return x, info, lu_out


def _b(a, seed, nrhs=None, cplx=False):
    rng = np.random.default_rng(seed)
    shape = (a.n_rows,) if nrhs is None else (a.n_rows, nrhs)
    b = rng.standard_normal(shape)
    if cplx:
        b = b + 1j * rng.standard_normal(shape)
    return b


def _op_residual(a, x, b, trans):
    import scipy.sparse as sp
    m = sp.csr_matrix((a.data, a.indices, a.indptr), shape=(a.n_rows,) * 2)
    m = {"NOTRANS": m, "TRANS": m.T, "CONJ": m.conj().T}[trans]
    return np.linalg.norm(b - m @ x) / np.linalg.norm(b)


CASES = {
    "notrans": ("convection_diffusion_2d", (9,), None, "NOTRANS", False),
    "notrans_nrhs3": ("convection_diffusion_2d", (9,), 3, "NOTRANS", False),
    "trans": ("convection_diffusion_2d", (9,), None, "TRANS", False),
    "complex_conj": ("helmholtz_2d", (8,), 2, "CONJ", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pgssvx_equals_jax_on_one_rank(case):
    gen, args, nrhs, trans, cplx = CASES[case]
    a = getattr(gallery, gen)(*args)
    ja = getattr(jgal, gen)(*args)
    b = _b(a, 7, nrhs, cplx)
    x, info, lo = _port_one_rank(slt.Options(trans=slt.Trans[trans]), a, b)
    jx, jinfo, jlo = _jax_one_rank(
        jslu.Options(trans=jslu.Trans[trans]), ja, b)
    assert info == jinfo == 0 and x.shape == b.shape == jx.shape
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)
    rep, jrep = lo["solve_report"], jlo["solve_report"]
    assert rep.berr <= TARGET and jrep.berr <= TARGET
    assert rep.converged and [r.name for r in rep.rungs] == \
        [r.name for r in jrep.rungs] == []
    assert _op_residual(a, x.reshape(a.n_rows, -1), b.reshape(a.n_rows, -1),
                        trans) < 1e-12
    assert lo["stats_summary"].n_ranks == 1 and "lu" in lo


def test_pgssvx_factored_reuse_equals_jax():
    a, ja = gallery.convection_diffusion_2d(9), jgal.convection_diffusion_2d(9)
    b1, b2 = _b(a, 1), _b(a, 2, 2)
    _, _, lo = _port_one_rank(slt.Options(), a, b1)
    _, _, jlo = _jax_one_rank(jslu.Options(), ja, b1)
    x2, info, lo2 = _port_one_rank(slt.Options(fact=slt.Fact.FACTORED), a,
                                   b2, lu=lo["lu"])
    jx2, _, _ = _jax_one_rank(jslu.Options(fact=jslu.Fact.FACTORED), ja, b2,
                              lu=jlo["lu"])
    assert info == 0 and lo2["lu"] is lo["lu"]
    np.testing.assert_allclose(x2, jx2, rtol=RTOL, atol=ATOL)
    assert lo2["stats"].ops["FACT"] == 0      # no new factorization


def test_distributed_hiprec_rung_equals_jax():
    """float32 factors of the near-singular arrowhead: the distributed
    refinement stagnates, and one collective rerun at float64 factors
    (the distributed-hiprec rung) reaches the target, as in the JAX
    package."""
    a = gallery.rank_deficient_arrowhead(**NEAR_SINGULAR)
    ja = jgal.rank_deficient_arrowhead(**NEAR_SINGULAR)
    b = a.matvec(np.random.default_rng(1).standard_normal(a.n_rows))
    x, info, lo = _port_one_rank(slt.Options(factor_dtype="float32"), a, b)
    jx, _, jlo = _jax_one_rank(jslu.Options(factor_dtype="float32"), ja, b)
    rep, jrep = lo["solve_report"], jlo["solve_report"]
    assert [r.name for r in rep.rungs] == [r.name for r in jrep.rungs] == \
        ["distributed-hiprec"]
    assert rep.rungs[0].detail == jrep.rungs[0].detail == "float64"
    assert info == 0 and rep.converged and rep.berr <= TARGET
    assert str(lo["lu"].numeric.dtype) == "torch.float64"
    np.testing.assert_allclose(x, jx, rtol=RTOL, atol=ATOL)


def _thread_solve(a, b, n_ranks, opts, max_len=64):
    parts = distribute_rows(a, n_ranks)

    def fn(tc):
        lu_out = {}
        x, info = pg.pgssvx(tc, opts, parts[tc.rank],
                            _blocks(parts[tc.rank], b), lu_out=lu_out,
                            device="cpu")
        return x, info, lu_out
    return run_ranks(n_ranks, fn, max_len=max_len)


def test_thread_ranks_bitwise_one_rank_at_notrans():
    """At NOTRANS every slot of the gather and of the residual allreduce
    has one nonzero contributor: x from 4 ranks is x from 1 rank bit for
    bit, and every peer's x is the root's."""
    a = gallery.poisson3d(6)
    b = _b(a, 3, 2)
    one = _thread_solve(a, b, 1, slt.Options())
    four = _thread_solve(a, b, 4, slt.Options(), max_len=48)
    x1 = one[0][0]
    for r, (x, info, lo) in four.items():
        assert info == 0
        np.testing.assert_array_equal(x, x1)
        assert lo["solve_report"].berr == one[0][2]["solve_report"].berr
        assert lo["stats_summary"].n_ranks == 4
    assert "lu" in four[0][2] and "lu" not in four[1][2]


def test_thread_ranks_trans_within_device_vs_host():
    a = gallery.convection_diffusion_2d(8)
    b = _b(a, 4)
    opts = slt.Options(trans=slt.Trans.TRANS)
    one = _thread_solve(a, b, 1, opts)
    three = _thread_solve(a, b, 3, opts)
    for r, (x, info, lo) in three.items():
        np.testing.assert_array_equal(x, three[0][0])
        assert lo["solve_report"].berr <= TARGET
    np.testing.assert_allclose(three[0][0], one[0][0], rtol=RTOL, atol=ATOL)


def test_root_exception_is_raised_on_every_rank():
    """A root-side failure inside a root-serial section is shipped to the
    peers (bcast_result) instead of stranding them in the broadcast —
    FACTORED without a handle, on three thread ranks."""
    a = gallery.poisson2d(6)
    out = _thread_solve(a, _b(a, 5), 3, slt.Options(fact=slt.Fact.FACTORED))
    for r, res in out.items():
        assert isinstance(res, SuperLUError), (r, res)
        assert "FACTORED requires a prior factorization" in str(res)

    def boom():
        raise KeyError("root only")
    got = run_ranks(3, lambda tc: pg.bcast_result(tc, boom, root=1))
    assert all(isinstance(e, KeyError) for e in got.values())
    assert run_ranks(2, lambda tc: pg.bcast_result(tc, lambda: [tc.rank],
                                                   root=1)) == \
        {0: [1], 1: [1]}


def test_root_analyze_bcast_strips_the_matrix():
    a = gallery.poisson2d(7)
    parts = distribute_rows(a, 2)

    def fn(tc):
        lu, bvals = pg.root_analyze_bcast(tc, slt.Options(), parts[tc.rank],
                                          slt.Stats(), device="cpu")
        return lu.a, lu.a_sym_indptr is not None, lu.plan.flops, bvals
    out = run_ranks(2, fn)
    assert out[0][0] is None and out[1][0] is None
    assert out[0][1] and not out[1][1]
    assert out[0][2] == out[1][2]
    np.testing.assert_array_equal(out[0][3], out[1][3])


@pytest.mark.parametrize("kw", [{"grid": "two-rank"},
                                {"replicate_analysis": True},
                                {"options": slt.Options(par_symb_fact=True)}],
                         ids=["grid", "replicate_analysis", "par_symb_fact"])
def test_mesh_tier_arguments_raise(kw):
    # the mesh tier runs (tests/test_torch_mesh.py); what it refuses: a
    # grid whose ranks are not the TreeComm's, in one all-reduce (the
    # check is collective, so a mismatch on one rank raises on all), and
    # its analysis choices without a grid, before any collective
    from superlu_dist_tpu_torch.parallel.grid import ProcessGrid
    a = gallery.poisson2d(4)
    part = distribute_rows(a, 1)[0]
    opts = kw.pop("options", slt.Options())
    if "grid" in kw:
        kw["grid"] = ProcessGrid(1, 2, 0, torch.device("cpu"), "gloo")
    with TreeComm(f"/slt_mesh_{os.getpid()}", 1, 0, max_len=16) as tc:
        with pytest.raises(SuperLUError, match="grid"):
            pg.pgssvx(tc, opts, part, np.ones(part.m_loc), device="cpu",
                      **kw)
        assert tc.seq == (1 if "grid" in kw else 0)


def test_options_ft_is_validated_like_jax():
    a = gallery.poisson2d(4)
    with pytest.raises(SuperLUError, match="Options.ft"):
        slt.gssvx(slt.Options(ft="shirnk"), a, np.ones(a.n_rows),
                  device="cpu")
    with pytest.raises(jslu.utils.errors.SuperLUError, match="Options.ft"):
        jslu.gssvx(jslu.Options(ft="shirnk"), jgal.poisson2d(4),
                   np.ones(a.n_rows))
    assert slt.Options().ft == jslu.Options().ft == "abort"


def test_three_spawned_processes_at_poisson3d_8():
    """The real multi-process shape: rank 0 here, ranks 1 and 2 spawned
    CPU processes (a process holding a CUDA context must not fork);
    every rank's x equals the root's bit for bit and no peer has a CUDA
    context."""
    a = gallery.poisson3d(8)
    b = _b(a, 0)
    job = RankJob("pgssvx", f"/slt_pgx3_{os.getpid()}", 3, slt.Options(),
                  RowBlockSource(a), VectorBlockSource(b), max_len=a.n_rows)
    procs, results, _ = spawn_peers({1: [job], 2: [job]})
    try:
        rec0 = run_job(job, 0, "cpu")
        recs = collect(results, 4, 120, procs)
    finally:
        codes = stop_peers(procs)
    assert codes == {1: 0, 2: 0}
    assert "error" not in rec0 and rec0["info"] == 0
    assert rec0["lu_out"]["solve_report"].berr <= TARGET
    assert _op_residual(a, rec0["x"], b, "NOTRANS") < 1e-12
    done = [r for r in recs if r.get("done")]
    assert len(done) == 2 and not any(r["cuda_initialized"] for r in done)
    for r in recs:
        if not r.get("done"):
            assert "error" not in r, r
            np.testing.assert_array_equal(r["x"], rec0["x"])
    assert not [f for f in os.listdir("/dev/shm") if job.name[1:] in f]
