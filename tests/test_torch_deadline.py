"""The port's cooperative deadline (utils/deadline.py) on the CPU: it
expires at a group boundary, flushes a resumable frontier first and raises
DeadlineExceededError — the same frontier the JAX package's deadline
leaves on the same inputs — through numeric_factorize, through gssvx's
``Options.deadline_s``, and under SIGTERM, which the loop honours at its
next boundary before the process ends."""

import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from superlu_dist_tpu.drivers.gssvx import analyze as jax_analyze
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.numeric.factor import (
    numeric_factorize as jax_numeric_factorize)
from superlu_dist_tpu.persist.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from superlu_dist_tpu.testing.chaos import CountdownDeadline
from superlu_dist_tpu.utils.options import Options as JaxOptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.persist import checkpoint
from superlu_dist_tpu_torch.utils import tols
from superlu_dist_tpu_torch.utils.deadline import Deadline
from superlu_dist_tpu_torch.utils.errors import DeadlineExceededError

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Countdown(Deadline):
    """Expires just before group n (the (n+1)-th poll)."""

    def __init__(self, n):
        super().__init__(0.0)
        self.n = n

    def expired_local(self):
        return self.polls > self.n


@pytest.mark.parametrize("k", [1, 4])
def test_deadline_leaves_the_frontier_the_jax_package_leaves(tmp_path, k):
    """poisson3d(8), float64: both packages stop before group k with a
    checkpoint of frontier k — the same plan fingerprint and value digest
    (the same identity), the pool and fronts equal at the cross-schedule
    drift gate — and the port's frontier resumes."""
    a = gallery.poisson3d(8)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
    ours = str(tmp_path / "port")
    with pytest.raises(DeadlineExceededError) as ei:
        factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                 dtype=torch.float64, device="cpu",
                                 ckpt_dir=ours, deadline=Countdown(k))
    err = ei.value
    assert err.checkpoint_path == os.path.abspath(ours)
    assert err.where == "numeric factorization" and err.expired_ranks == 0
    jlu, jbvals, _ = jax_analyze(JaxOptions(), jgal.poisson3d(8))
    theirs = str(tmp_path / "jax")
    with pytest.raises(Exception, match="deadline"):
        jax_numeric_factorize(jlu.plan, jbvals, jlu.anorm, dtype="float64",
                              ckpt_dir=theirs, deadline=CountdownDeadline(k))
    got = checkpoint.load_checkpoint(ours)
    want = jax_load_checkpoint(theirs)
    assert got.k == want.k == k
    for key in ("n_groups", "plan_fingerprint", "values_digest",
                "factor_dtype", "tiny"):
        assert got.meta[key] == want.meta[key], key
    np.testing.assert_allclose(got.pool, want.pool,
                               rtol=tols.SCHEDULE_DRIFT_RTOL,
                               atol=tols.SCHEDULE_DRIFT_ATOL)
    for (l1, u1), (l2, u2) in zip(got.fronts, want.fronts):
        np.testing.assert_allclose(l1, l2, rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
        np.testing.assert_allclose(u1, u2, rtol=tols.SCHEDULE_DRIFT_RTOL,
                                   atol=tols.SCHEDULE_DRIFT_ATOL)
    res = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                   dtype=torch.float64, device="cpu",
                                   resume_from=ours)
    assert res.resumed_groups == k and len(res.fronts) == len(lu.plan.groups)


def test_expiry_before_the_first_group_leaves_no_frontier(tmp_path):
    a = gallery.poisson3d(6)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
    with pytest.raises(DeadlineExceededError) as ei:
        factor.numeric_factorize(lu.plan, bvals, lu.anorm, device="cpu",
                                 ckpt_dir=str(tmp_path / "ck"),
                                 deadline=Deadline(0.0))
    assert ei.value.checkpoint_path is None
    assert "deadline of 0.000s exceeded" in str(ei.value)


def test_options_deadline_stops_gssvx(tmp_path):
    """Options(deadline_s=..., ckpt_dir=...) bound the driver's FACT; a
    frontier, when one exists, resumes through gssvx(resume_from=)."""
    a = gallery.poisson3d(8)
    b = a.matvec(np.ones(a.n_rows))
    ck = str(tmp_path / "ck")
    with pytest.raises(DeadlineExceededError):
        slt.gssvx(slt.Options(deadline_s=1e-9, ckpt_dir=ck), a, b,
                  device="cpu")
    x, lu, st, info = slt.gssvx(slt.Options(deadline_s=3600.0, ckpt_dir=ck),
                                a, b, device="cpu")
    assert info == 0 and st.solve_report.berr <= tols.berr_target(np.float64)
    assert not os.path.exists(os.path.join(ck, "MANIFEST.json"))


@pytest.mark.parametrize("kw,error", [
    (dict(deadline_s=-1.0), ValueError),
    (dict(ckpt_every=-2), ValueError),
])
def test_options_validate_the_persistence_fields(kw, error):
    with pytest.raises(error):
        slt.Options(**kw)


def test_options_zero_deadline_is_off():
    """0 is off, as the JAX package's SLU_TPU_DEADLINE_S=0."""
    assert slt.Options(deadline_s=0).deadline_s is None
    assert slt.Options().ckpt_every == 0 and slt.Options().ckpt_dir == ""


def test_a_collective_deadline_is_not_ported():
    """The collective deadline is ported now: with a comm, each poll
    allreduces the expired flag, and the raise counts the ranks over
    budget — one rank here, as the JAX package's over the same comm."""
    from superlu_dist_tpu.parallel.treecomm import TreeComm as JTreeComm
    from superlu_dist_tpu.utils.deadline import Deadline as JDeadline
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    got = []
    for dcls, tcls in ((Deadline, TreeComm), (JDeadline, JTreeComm)):
        with tcls(f"/slt_dl_{os.getpid()}", 1, 0, max_len=16) as tc:
            d = dcls(0.0, comm=tc, poll_every=2)
            d.poll("g0")              # off-cadence: no exchange, no raise
            with pytest.raises(Exception) as ei:
                d.poll("g1")
            got.append((type(ei.value).__name__, ei.value.expired_ranks,
                        ei.value.where, tc.seq))
    assert got[0] == got[1] == ("DeadlineExceededError", 1, "g1", 1)


_SIGTERM = r"""
import os, signal, sys
sys.path.insert(0, {root!r})
import torch
import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models.gallery import poisson3d
from superlu_dist_tpu_torch.numeric import factor
a = poisson3d(8)
lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
calls = [0]

def scatter(avals, pool, m, w, gm):
    calls[0] += 1
    if calls[0] == 4:           # inside group 3
        os.kill(os.getpid(), signal.SIGTERM)
    return factor.KERNELS(avals, pool, m, w, gm)

factor.numeric_factorize(lu.plan, bvals, lu.anorm, dtype=torch.float64,
                         device="cpu", ckpt_dir={ck!r}, scatter=scatter)
print("survived")
"""


def test_sigterm_is_honoured_at_the_next_boundary(tmp_path):
    """A SIGTERM inside group 3: the loop finishes the group, flushes
    frontier 4, and the process then ends by the signal; the frontier
    resumes to fronts equal to an uninterrupted run."""
    ck = str(tmp_path / "ck")
    out = subprocess.run(
        [sys.executable, "-c", _SIGTERM.format(root=str(ROOT), ck=ck)],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == -signal.SIGTERM, out.stderr
    assert "survived" not in out.stdout
    meta = checkpoint.peek(ck)
    assert (meta["k"], meta["reason"]) == (4, "SIGTERM")
    a = gallery.poisson3d(8)
    lu, bvals, _ = slt.analyze(slt.Options(), a, device="cpu")
    ref = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                   dtype=torch.float64, device="cpu")
    res = factor.numeric_factorize(lu.plan, bvals, lu.anorm,
                                   dtype=torch.float64, device="cpu",
                                   resume_from=ck)
    assert res.resumed_groups == 4
    assert all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
               for p, q in zip(res.fronts, ref.fronts))
