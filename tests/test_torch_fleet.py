"""The port's serving fleet (superlu_dist_tpu_torch/serve/fleet.py and
serve/handlecache.py) on the CPU: the HandleCache evicts in the JAX
package's LRU order under the same byte budget; thread replicas serve a
mixed stream, fail over a killed replica with every X bit for bit the
undisturbed run, route around a quarantined one and wait out a slow one;
fleet backpressure, deadlines and close; a rolling deploy with a
poisoned bundle rolled back; the fleet refactor bit for bit the port's
own refactor; and one fleet of two spawned process replicas with a
replica killed mid-stream and its tickets failed over, every wait
bounded."""

import os

import numpy as np
import pytest

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.persist.serial import lu_meta as jax_lu_meta
from superlu_dist_tpu.persist.serial import save_lu as jax_save_lu
from superlu_dist_tpu.serve import HandleCache as JaxHandleCache
from superlu_dist_tpu.serve.fleet import pid_alive as jax_pid_alive

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.obs import metrics
from superlu_dist_tpu_torch.persist.serial import lu_meta
from superlu_dist_tpu_torch.serve import FleetRouter, HandleCache
from superlu_dist_tpu_torch.serve.fleet import FLEET_SERVER_KW, pid_alive
from superlu_dist_tpu_torch.utils.errors import (DeployRollbackError,
                                                 ReplicaFailureError,
                                                 ServeDeadlineError,
                                                 ServeOverloadError,
                                                 ServerClosedError,
                                                 SuperLUError)

pytestmark = pytest.mark.fleet

KEYS = ("m0", "m1", "m2")
_NX = {"m0": 6, "m1": 7, "m2": 8}
CPU = "cpu"


def _factor(a):
    x, lu, st, info = slt.gssvx(
        slt.Options(iter_refine=slt.IterRefine.NOREFINE), a,
        np.ones(a.n_rows), device=CPU)
    assert info == 0
    return lu


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fleet")
    paths, mats = {}, {}
    for key in KEYS:
        a = gallery.poisson2d(_NX[key])
        paths[key] = str(root / key)
        slt.save_lu(_factor(a), paths[key])
        mats[key] = a
    return paths, mats


def _stream(fleet, mats, n=12, seed=0, keys=KEYS):
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        a = mats[keys[j % len(keys)]]
        out.append(fleet.submit(keys[j % len(keys)],
                                a.matvec(rng.standard_normal(a.n_rows))))
    return out


def _run(paths, mats, monkeypatch, chaos=None, n_replicas=3, n=12, **kw):
    if chaos is None:
        monkeypatch.delenv("SLU_TPU_CHAOS", raising=False)
    else:
        monkeypatch.setenv("SLU_TPU_CHAOS", chaos)
    fleet = FleetRouter(paths, n_replicas=n_replicas, kind="thread",
                        device=CPU, **kw)
    try:
        xs = [t.result(120) for t in _stream(fleet, mats, n=n,
                                             keys=tuple(paths))]
        return xs, fleet.stats()
    finally:
        fleet.close()
        monkeypatch.delenv("SLU_TPU_CHAOS", raising=False)


# ---------------------------------------------------------------------------
# the handle cache
# ---------------------------------------------------------------------------

def _lru_trace(cache_cls, path, nbytes, keys, seq, **kw):
    cache = cache_cls(2 * nbytes + 100, dict(FLEET_SERVER_KW), **kw)
    for k in keys:
        cache.register(k, path)
    out = []
    for k in seq:
        cache.get(k)
        out.append(tuple(cache.resident()))
    st = cache.stats()
    cache.close()
    return out, (st["loads"], st["hits"], st["evictions"])


def test_handle_cache_evicts_in_the_jax_lru_order(bundles, tmp_path):
    """One bundle of each package under three keys, a budget of two
    handles, the same access sequence: the same residents after every
    get, the same loads, hits and evictions."""
    paths, mats = bundles
    jlu = jslu.gssvx(jslu.Options(iter_refine=jslu.IterRefine.NOREFINE),
                     jgal.poisson2d(6), np.ones(36))[1]
    jpath = str(tmp_path / "jax_m0")
    jax_save_lu(jlu, jpath)
    seq = ["a", "b", "a", "c", "b", "a", "a", "c"]
    mine = _lru_trace(HandleCache, paths["m0"],
                      lu_meta(paths["m0"])["nbytes"], "abc", seq,
                      device=CPU)
    ref = _lru_trace(JaxHandleCache, jpath, jax_lu_meta(jpath)["nbytes"],
                     "abc", seq)
    assert mine == ref
    assert mine[1][2] >= 3


def test_handle_cache_busy_entries_and_reload(bundles):
    paths, mats = bundles
    cache = HandleCache(1, FLEET_SERVER_KW, device=CPU)
    cache.register("m0", paths["m0"])
    cache.register("m1", paths["m1"])
    srv = cache.get("m0")
    assert srv.device.type == "cpu"
    b0 = mats["m0"].matvec(np.ones(36))
    ref = srv.solve(b0, 60)
    srv.idle = lambda: False                # pinned busy
    cache.get("m1")
    assert "m0" in cache.resident()
    assert cache.stats()["resident_bytes"] > cache.budget_bytes
    assert cache.drop("m0") and not cache.drop("m0")
    np.testing.assert_array_equal(cache.get("m0").solve(b0, 60), ref)
    with pytest.raises(SuperLUError, match="not registered"):
        cache.get("never")
    cache.close()
    with pytest.raises(RuntimeError, match="cuda"):
        HandleCache(0)


# ---------------------------------------------------------------------------
# thread replicas: routing, failover
# ---------------------------------------------------------------------------

def test_mixed_stream_round_trip(bundles, monkeypatch):
    paths, mats = bundles
    xs, st = _run(paths, mats, monkeypatch, n_replicas=2)
    assert st["delivered"] == 12 and st["errors"] == 0
    assert st["failovers"] == 0 and st["replicas_healthy"] == 2
    rng = np.random.default_rng(0)
    for j, x in enumerate(xs):
        key = KEYS[j % 3]
        b = mats[key].matvec(rng.standard_normal(mats[key].n_rows))
        lu = slt.load_lu(paths[key], device=CPU)
        np.testing.assert_array_equal(x, lu.solve_factored(b))


def test_kill_replica_failover_bitwise(bundles, monkeypatch):
    paths, mats = bundles
    ref, st0 = _run(paths, mats, monkeypatch)
    got, st = _run(paths, mats, monkeypatch, chaos="kill_replica=1@batch=2")
    assert st["failovers"] >= 1 and st["replicas_failed"] == [1]
    assert st["errors"] == 0 and st["delivered"] == 12
    assert st["reroutes"] >= 1
    for i, (r, g) in enumerate(zip(ref, got)):
        assert np.array_equal(r, g), f"ticket {i} drifted"


def test_quarantine_and_slow_replicas(bundles, monkeypatch):
    paths, mats = bundles
    got, st = _run(paths, mats, monkeypatch, chaos="quarantine_replica=0",
                   n_replicas=2, n=9)
    assert st["errors"] == 0 and st["delivered"] == 9
    assert st["failovers"] >= 1 and st["replicas_failed"] == []
    got, st = _run(paths, mats, monkeypatch, chaos="slow_replica=0,secs=0.4",
                   n_replicas=2, n=6, health_s=0.02)
    assert st["failovers"] == 0 and st["reroutes"] == 0
    assert st["errors"] == 0 and st["delivered"] == 6


def test_no_healthy_replica_left(bundles, monkeypatch):
    paths, mats = bundles
    monkeypatch.setenv("SLU_TPU_CHAOS", "kill_replica=0@batch=1")
    fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=1, kind="thread",
                        device=CPU)
    try:
        b = mats["m0"].matvec(np.ones(36))
        outcomes = []
        for t in [fleet.submit("m0", b) for _ in range(4)]:
            try:
                t.result(60)
                outcomes.append("ok")
            except ReplicaFailureError:
                outcomes.append("rfail")
        assert outcomes[0] == "ok" and "rfail" in outcomes
    finally:
        fleet.close()
    with pytest.raises(ServerClosedError):
        fleet.submit("m0", b)


# ---------------------------------------------------------------------------
# backpressure, deadlines, drain, close
# ---------------------------------------------------------------------------

def test_fleet_shed_drain_and_deadline(bundles, monkeypatch):
    paths, mats = bundles
    b = mats["m0"].matvec(np.ones(36))
    monkeypatch.setenv("SLU_TPU_CHAOS", "slow_replica=0,secs=0.3")
    fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=1, kind="thread",
                        queue_max=4, device=CPU)
    try:
        ok, shed = [], 0
        for _ in range(4):
            try:
                ok.append(fleet.submit("m0", np.stack([b] * 3, 1)))
            except ServeOverloadError as e:
                assert e.reason == "fleet_queue_full"
                shed += 1
        assert shed and fleet.stats()["shed"] == shed
        assert fleet.drain(timeout=60) and all(t.done() for t in ok)
        with pytest.raises(ServeOverloadError, match="draining"):
            fleet.submit("m0", b)
        fleet.resume()
        fleet.solve("m0", b, timeout=60)
        with pytest.raises(SuperLUError, match="not registered"):
            fleet.submit("nope", b)
    finally:
        fleet.close()
    monkeypatch.setenv("SLU_TPU_CHAOS", "slow_replica=0,secs=1.0")
    fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=1, kind="thread",
                        deadline_s=0.1, health_s=0.02, device=CPU)
    try:
        verdicts = []
        for t in [fleet.submit("m0", b) for _ in range(3)]:
            try:
                t.result(30)
                verdicts.append("ok")
            except ServeDeadlineError:
                verdicts.append("deadline")
        assert "deadline" in verdicts
        assert fleet.stats()["failovers"] == 0
    finally:
        fleet.close()


def test_close_delivers_structured_errors(bundles, monkeypatch):
    paths, mats = bundles
    monkeypatch.setenv("SLU_TPU_CHAOS", "slow_replica=0,secs=0.5")
    fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=1, kind="thread",
                        device=CPU)
    b = mats["m0"].matvec(np.ones(36))
    tickets = [fleet.submit("m0", b) for _ in range(4)]
    fleet.close()
    for t in tickets:
        try:
            t.result(10)
        except (ServerClosedError, ReplicaFailureError):
            pass
        assert t.done()


# ---------------------------------------------------------------------------
# deploy, refactor
# ---------------------------------------------------------------------------

def _poisoned(mats, tmp_path, name):
    lu = _factor(mats["m0"])
    lp, up = lu.numeric.fronts[0]
    lu.numeric.fronts[0] = (lp * float("nan"), up)
    d = str(tmp_path / name)
    slt.save_lu(lu, d)
    return d


def test_rolling_deploy_and_rollback(bundles, tmp_path, monkeypatch):
    paths, mats = bundles
    monkeypatch.delenv("SLU_TPU_CHAOS", raising=False)
    a = mats["m0"]
    good = str(tmp_path / "m0_v2")
    slt.save_lu(_factor(a), good)
    fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=2, kind="thread",
                        device=CPU)
    try:
        b = a.matvec(np.ones(36))
        ref = fleet.solve("m0", b, timeout=60)
        out = fleet.deploy(good, a=a, berr_max=1e-10)
        assert out["replicas_swapped"] == [0, 1]
        np.testing.assert_array_equal(ref, fleet.solve("m0", b, 60))
        with pytest.raises(DeployRollbackError) as ei:
            fleet.deploy(_poisoned(mats, tmp_path, "bad1"))
        assert ei.value.stage == "canary" and ei.value.rolled_back == []
        with pytest.raises(DeployRollbackError) as ei:
            fleet.deploy(_poisoned(mats, tmp_path, "bad2"), preflight=False)
        assert ei.value.replica == 0 and ei.value.rolled_back == [0]
        st = fleet.stats()
        assert st["deploys"] == 1 and st["rollbacks"] == 2
        for _ in range(3):
            np.testing.assert_array_equal(ref, fleet.solve("m0", b, 60))
    finally:
        fleet.close()


def test_fleet_refactor_bitwise_the_port_refactor(bundles, tmp_path,
                                                  monkeypatch):
    paths, mats = bundles
    monkeypatch.delenv("SLU_TPU_CHAOS", raising=False)
    a = mats["m1"]
    vals = a.data * (1.0 + 0.1 * np.random.default_rng(2).random(a.nnz))
    new = slt.SparseCSR(a.n_rows, a.n_cols, a.indptr, a.indices, vals)
    fleet = FleetRouter({"m1": paths["m1"]}, n_replicas=2, kind="thread",
                        device=CPU)
    try:
        out = fleet.refactor("m1", new, workdir=str(tmp_path))
        assert out["replicas_swapped"] == [0, 1]
        mine = slt.load_lu(paths["m1"], device=CPU)
        slt.refactor(mine, new)
        b = new.matvec(np.ones(a.n_rows))
        for _ in range(2):
            np.testing.assert_array_equal(fleet.solve("m1", b, 60),
                                          mine.solve_factored(b))
        assert fleet.stats()["refactors"] == 1
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# evidence, liveness
# ---------------------------------------------------------------------------

def test_fleet_metrics_and_pid_alive(bundles, monkeypatch):
    paths, mats = bundles
    m = metrics.Metrics()
    prev = metrics.install(m)
    monkeypatch.setenv("SLU_TPU_CHAOS", "kill_replica=0@batch=1")
    try:
        fleet = FleetRouter({"m0": paths["m0"]}, n_replicas=2,
                            kind="thread", device=CPU)
        b = mats["m0"].matvec(np.ones(36))
        for t in [fleet.submit("m0", b) for _ in range(6)]:
            t.result(60)
        fleet.close()
    finally:
        metrics.install(prev)
    c = m.snapshot()["counters"]
    assert c["slu_fleet_requests_total"] == 6.0
    assert c["slu_fleet_failovers_total"] >= 1.0
    assert c["slu_fleet_reroutes_total"] >= 1.0
    assert "slu_fleet_route_seconds" in m.snapshot()["histograms"]
    for pid in (os.getpid(), -1, 0, 2 ** 22 + 7):
        assert pid_alive(pid) == jax_pid_alive(pid)


# ---------------------------------------------------------------------------
# process replicas
# ---------------------------------------------------------------------------

def test_process_replicas_kill_and_failover(bundles, monkeypatch):
    """Two spawned replicas; chaos SIGKILLs replica 1 before its second
    batch.  Every accepted ticket is delivered, bit for bit the thread
    fleet's answer, and close() reaps both children."""
    paths, mats = bundles
    two = {k: paths[k] for k in ("m0", "m1")}
    ref, _ = _run(two, mats, monkeypatch, n_replicas=2, n=6)
    monkeypatch.setenv("SLU_TPU_CHAOS", "kill_replica=1@batch=1")
    fleet = FleetRouter(two, n_replicas=2, kind="process", device=CPU)
    try:
        assert all(r.device.type == "cpu" for r in fleet._replicas)
        got = [t.result(120) for t in _stream(fleet, mats, n=6,
                                              keys=("m0", "m1"))]
        st = fleet.stats()
        assert st["errors"] == 0 and st["delivered"] == 6
        assert st["failovers"] >= 1 and 1 in st["replicas_failed"]
        for r, g in zip(ref, got):
            assert np.array_equal(r, g)
    finally:
        fleet.close(timeout=20)
    for r in fleet._replicas:
        assert not r._proc.is_alive()
