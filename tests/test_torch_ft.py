"""Rank-failure tolerance of the port (parallel/treecomm.py failure
detector, parallel/recover.py) on the CPU, held to the JAX package's
contract: with ``SLU_TPU_COMM_TIMEOUT_S`` armed a rank that DIES surfaces
as a structured RankFailureError on EVERY survivor within about twice
the timeout; a rank that is merely SLOW is never declared failed; a live
peer past the retry budget is a CommTimeoutError; ``Options.ft="shrink"``
resumes the checkpoint frontier on the survivors bit for bit, and
``"respawn"`` completes with a replacement process.

Ranks that die are spawned processes (testing/ranks.py): a kill takes
the whole process, and a process that holds torch must not fork.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from superlu_dist_tpu.testing import chaos as jchaos
from superlu_dist_tpu.utils import errors as jerrors

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch import native
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.obs import flightrec
from superlu_dist_tpu_torch.parallel.recover import (FT_EVENTS,
                                                     RowBlockSource,
                                                     VectorBlockSource)
from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.testing import chaos
from superlu_dist_tpu_torch.testing.ranks import (RankJob, collect,
                                                  run_job, spawn_peers,
                                                  stop_peers)
from superlu_dist_tpu_torch.utils.errors import (CommTimeoutError,
                                                 RankFailureError,
                                                 SuperLUError)

pytestmark = pytest.mark.ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 0.4


def _no_segments(prefix):
    return not [f for f in os.listdir("/dev/shm") if prefix[1:] in f]


# ---------------------------------------------------------------------------
# spec / error-surface units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["kill_rank=1@group=3,signal=term",
                                  "kill_rank=2,kill_op=4",
                                  "stall_rank=1,secs=0.5", "nan_supernode=3"])
def test_parse_chaos_ft_specs_equal_jax(spec):
    p, j = chaos.parse_chaos_spec(spec), jchaos.parse_chaos_spec(spec)
    for f in ("kill_rank", "kill_group", "kill_op", "stall_rank", "secs",
              "signal", "epoch"):
        assert getattr(p, f) == getattr(j, f), f
    assert (p.comm_armed, p.armed) == (j.comm_armed, j.armed)


def test_rank_failure_error_carries_structure_as_jax():
    kw = dict(op="bcast_any", seq=7, site="parallel/pgssvx.py:277", rank=1,
              n_ranks=3, epoch=0)
    e, je = RankFailureError({2, 0}, **kw), jerrors.RankFailureError({2, 0},
                                                                     **kw)
    assert e.dead_ranks == [0, 2] and str(e) == str(je)
    assert isinstance(e, SuperLUError) and hasattr(e, "flightrec_dump")
    t = CommTimeoutError("reduce_sum", 1, 0.5, 3, seq=4, site="x.py:1")
    assert str(t) == str(jerrors.CommTimeoutError("reduce_sum", 1, 0.5, 3,
                                                  seq=4, site="x.py:1"))
    assert t.stuck_rank == 1 and "slow, not dead" in str(t)


def test_rank_failure_dumps_the_flight_recorder(tmp_path):
    dump = tmp_path / "flight.json"
    fr = flightrec.FlightRecorder(dump_path=str(dump))
    flightrec.install(fr)
    try:
        fr.event("pre-failure", cat="comm")
        e = RankFailureError([1], op="bcast", seq=3, site="x.py:2", rank=0,
                             n_ranks=2)
        assert e.flightrec_dump == str(dump)
        assert "RankFailureError" in json.loads(dump.read_text())["reason"]
    finally:
        flightrec._reset()


def test_native_timed_leg_bounds_the_wait():
    """The timed reduce returns 1 + the stuck rank within about the
    timeout when the peer never arrives and leaves the payload untouched;
    a root bcast at op 1 waits on nobody."""
    lib = native.load()
    name = f"/slt_ft_unit_{os.getpid()}".encode()
    h = lib.slu_tree_attach(name, 2, 16, 0, 1)
    try:
        buf = np.arange(4.0)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        t0 = time.monotonic()
        rc = lib.slu_tree_reduce_sum_tw(h, 0, ptr, 4, TIMEOUT_S)
        dt = time.monotonic() - t0
        assert rc == 2 and TIMEOUT_S * 0.8 < dt < TIMEOUT_S * 3
        np.testing.assert_array_equal(buf, np.arange(4.0))
        assert lib.slu_tree_bcast_tw(h, 0, ptr, 4, TIMEOUT_S) == 0
    finally:
        lib.slu_tree_detach(h, name, 1)


def test_heartbeat_and_board_roundtrip(monkeypatch):
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("SLU_TPU_HEARTBEAT_S", "0.05")
    name = f"/slt_fthb_{os.getpid()}"
    a = TreeComm(name, 2, 0, max_len=64, create=True)
    b = TreeComm(name, 2, 1, max_len=64, create=False)
    try:
        hb0 = native.load().slu_tree_get_heartbeat(a._h, 0)
        time.sleep(0.3)
        assert native.load().slu_tree_get_heartbeat(a._h, 0) > hb0
        assert b._detector.heartbeat_age(0) == 0.0
        assert b._detector.pid(0) == os.getpid()
        assert b._detector.dead_ranks() == set()
        assert 0.0 < a._detector.max_beat_gap_s < 5.0
        a._detector.post_failure({1}, epoch=0)
        assert b._detector.posted_failures(epoch=0) == {0: {1}}
        assert b._detector.posted_failures(epoch=3) == {}
    finally:
        b.close()
        a.close(unlink=True)
    assert _no_segments(name)


def test_bounded_retries_raise_comm_timeout_on_a_live_peer(monkeypatch):
    """A peer that attached (its pid is alive) but never enters the
    collective: with SLU_TPU_COMM_RETRIES=2 the slow-not-dead verdict is
    CommTimeoutError, never RankFailureError."""
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", str(TIMEOUT_S))
    monkeypatch.setenv("SLU_TPU_COMM_RETRIES", "2")
    name = f"/slt_ftto_{os.getpid()}"
    tc = TreeComm(name, 2, 0, max_len=64, create=True)
    idle = TreeComm(name, 2, 1, max_len=64, create=False)
    try:
        with pytest.raises(CommTimeoutError) as ei:
            tc.allreduce_sum_any(np.ones(4))
        assert ei.value.stuck_rank == 1 and ei.value.retries == 2
    finally:
        idle.close()
        tc.close(unlink=True)


def test_dying_tree_comm_exits_mid_protocol():
    code = ("import numpy as np, os\n"
            "from superlu_dist_tpu_torch.testing.chaos import DyingTreeComm\n"
            f"tc = DyingTreeComm('/slt_dying_{os.getpid()}', 1, 0, "
            "max_len=8, die_after=1)\n"
            "tc.allreduce_sum_any(np.ones(2))\n"
            "print('one op done', flush=True)\n"
            "tc.allreduce_sum_any(np.ones(2))\n"
            "print('not reached')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    # the dead creator left its segment behind: remove it
    seg = f"/dev/shm/slt_dying_{os.getpid()}"
    if os.path.exists(seg):
        os.unlink(seg)
    assert proc.returncode == chaos.RANK_DEATH_EXIT, proc.stderr
    assert "one op done" in proc.stdout and "not reached" not in proc.stdout


# ---------------------------------------------------------------------------
# spawned ranks
# ---------------------------------------------------------------------------

def _allreduce_job(name, n_ranks, ops, **kw):
    return RankJob("allreduce", name, n_ranks, None, None, None, max_len=64,
                   ops=ops, **kw)


def test_death_raises_on_every_survivor(monkeypatch):
    """Rank 2 dies before its second collective: rank 0 (this process)
    and rank 1 (spawned) both raise RankFailureError naming rank 2, the
    op and the call site, within twice the timeout of the stall."""
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", str(TIMEOUT_S))
    name = f"/slt_ft3_{os.getpid()}"
    tc = TreeComm(name, 3, 0, max_len=64, create=True)
    procs, results, _ = spawn_peers({
        1: [_allreduce_job(name, 3, 2, hold_s=3.0)],
        2: [_allreduce_job(name, 3, 2,
                           env={"SLU_TPU_CHAOS": "kill_rank=2,kill_op=2"})]})
    try:
        assert (tc.allreduce_sum_any(np.ones(4)) == 3).all()
        t0 = time.monotonic()
        with pytest.raises(RankFailureError) as ei:
            tc.allreduce_sum_any(np.ones(4))
        dt = time.monotonic() - t0
        recs = collect(results, 2, 60, procs)
    finally:
        codes = stop_peers(procs)
        tc.close(unlink=True)
    assert ei.value.dead_ranks == [2] and ei.value.op and ei.value.site
    assert dt < 2 * TIMEOUT_S + 1.0, dt
    peer = [r for r in recs if not r.get("done")][0]
    assert peer["rank"] == 1 and peer["failure"]["dead"] == [2]
    assert peer["failure"]["op"] and peer["failure"]["site"]
    assert codes == {1: 0, 2: -9}
    assert _no_segments(name)


def test_a_stall_is_never_declared_a_failure(monkeypatch):
    """A peer stalled for four timeouts (pid alive) is waited out: the
    collective completes with the right value and nobody is declared
    dead."""
    stall = 4 * TIMEOUT_S
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", str(TIMEOUT_S))
    name = f"/slt_ftstall_{os.getpid()}"
    tc = TreeComm(name, 2, 0, max_len=64, create=True)
    spec = f"stall_rank=1,secs={stall},stall_op=2"
    procs, results, _ = spawn_peers({1: [_allreduce_job(
        name, 2, 2, env={"SLU_TPU_CHAOS": spec})]})
    try:
        assert (tc.allreduce_sum_any(np.ones(4)) == 2).all()
        t0 = time.monotonic()
        out = tc.allreduce_sum_any(np.ones(4))
        dt = time.monotonic() - t0
        recs = collect(results, 2, 60, procs)
    finally:
        codes = stop_peers(procs)
        tc.close(unlink=True)
    assert (out == 2).all() and dt >= 0.8 * stall, dt
    peer = [r for r in recs if not r.get("done")][0]
    assert "error" not in peer and (peer["x"] == 2).all()
    assert codes == {1: 0}


def test_shrink_resumes_the_frontier_bit_for_bit(monkeypatch, tmp_path):
    """Options.ft="shrink": the root (rank 0) is SIGKILLed after dispatch
    group 3 with interval checkpoints armed; the survivor shrinks to a
    solo epoch, resumes the durable frontier, and delivers x bit for bit
    that of an undisturbed run, with one FtEvent and the ft-shrink and
    resume-from-checkpoint rungs recorded."""
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", "1.0")
    a = gallery.poisson3d(6)
    b = a.matvec(np.random.default_rng(0).standard_normal(a.n_rows))
    src = RowBlockSource(a), VectorBlockSource(b)

    def job(tag, n_ranks, **kw):
        opts = slt.Options(ft="shrink", ckpt_every=2,
                           ckpt_dir=str(tmp_path / tag))
        return RankJob("pgssvx_ft", f"/slt_ftshr_{tag}_{os.getpid()}",
                       n_ranks, opts, *src, max_len=a.n_rows, **kw)

    ref = run_job(job("ref", 1), 0, "cpu")
    assert "error" not in ref and ref["info"] == 0
    shr = job("shr", 2)
    procs, results, _ = spawn_peers({
        0: [job("shr", 2, env={"SLU_TPU_CHAOS": "kill_rank=0@group=3"})],
        1: [shr]})
    try:
        recs = collect(results, 2, 120, procs)
    finally:
        codes = stop_peers(procs)
    assert codes == {0: -9, 1: 0}
    rec = [r for r in recs if not r.get("done")][0]
    assert rec["rank"] == 1 and "error" not in rec and rec["info"] == 0
    np.testing.assert_array_equal(rec["x"], ref["x"])
    (ev,) = rec["lu_out"]["ft_events"]
    assert ev.dead == [0] and ev.mode == "shrink" and ev.resumed
    assert rec["lu_out"]["recovered"]
    names = [r.name for r in rec["lu_out"]["solve_report"].rungs]
    assert "ft-shrink" in names
    assert _no_segments(shr.name)


def test_respawn_completes(monkeypatch):
    """Options.ft="respawn": rank 1 dies mid-gather; this process (rank 0)
    spawns a replacement that takes over rank 1 in epoch 1, and the
    two-rank solve completes with one recorded recovery."""
    monkeypatch.setenv("SLU_TPU_COMM_TIMEOUT_S", "1.0")
    a = gallery.poisson3d(5)
    b = a.matvec(np.random.default_rng(2).standard_normal(a.n_rows))
    job = RankJob("pgssvx_ft", f"/slt_ftresp_{os.getpid()}", 2,
                  slt.Options(ft="respawn"), RowBlockSource(a),
                  VectorBlockSource(b), max_len=a.n_rows)
    victim = RankJob(**{**job.__dict__,
                        "env": {"SLU_TPU_CHAOS": "kill_rank=1,kill_op=4"}})
    n_events = len(FT_EVENTS)
    procs, results, _ = spawn_peers({1: [victim]})
    try:
        rec0 = run_job(job, 0, "cpu")
    finally:
        codes = stop_peers(procs)
    assert codes == {1: -9}
    assert "error" not in rec0 and rec0["info"] == 0
    assert len(FT_EVENTS) == n_events + 1
    assert FT_EVENTS[-1].mode == "respawn" and FT_EVENTS[-1].dead == [1]
    assert "ft-respawn" in [r.name for r in
                            rec0["lu_out"]["solve_report"].rungs]
    r = b - a.matvec(rec0["x"])
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-12
    assert _no_segments(job.name)
