"""The port's SolveServer (superlu_dist_tpu_torch/serve/server.py) on the
CPU, held against the JAX package's SolveServer on the same seeded
inputs: the same backlog submitted before ``start()`` makes the same
batches of the same widths and equal ``stats()`` counters, with X within
the device-vs-host gate; shedding at the same ``queue_max``; deadline
expiry; poisoned columns named, their neighbours bit for bit an
unpoisoned dispatch; the ``serve-ir`` rung delivering at the gate;
``from_bundle`` serving with FACT 0; ``swap`` and ``refactor`` bit for
bit the port's own ``refactor`` plus ``solve_factored``; a corrupted
resident panel quarantining the handle; drain and close as the
reference's; the serve cycle clean under the lock-order verifier."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

import superlu_dist_tpu as jslu
from superlu_dist_tpu.models import gallery as jgal
from superlu_dist_tpu.serve import SolveServer as JaxServer

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.obs import flightrec, metrics, trace
from superlu_dist_tpu_torch.serve import SolveServer
from superlu_dist_tpu_torch.utils import lockwatch, tols
from superlu_dist_tpu_torch.utils.errors import (FactorCorruptError,
                                                 NumericBreakdownError,
                                                 PatternMismatchError,
                                                 ServeDeadlineError,
                                                 ServeOverloadError,
                                                 ServePoisonedError,
                                                 ServerClosedError,
                                                 SuperLUError)

pytestmark = pytest.mark.serve

RTOL, ATOL = tols.DEVICE_VS_HOST_RTOL, tols.DEVICE_VS_HOST_ATOL
CPU = "cpu"
NOREF = dict(iter_refine=slt.IterRefine.NOREFINE)


def _port(a, **kw):
    x, lu, st, info = slt.gssvx(slt.Options(**NOREF, **kw), a,
                                np.ones(a.n_rows), device=CPU)
    assert info == 0
    return lu


@pytest.fixture(scope="module")
def factored():
    """poisson2d(10) factored by both packages, 70 seeded right-hand
    sides."""
    a, ja = gallery.poisson2d(10), jgal.poisson2d(10)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((a.n_rows, 70))
    bs = a.matvec(xs)
    _, jlu, _, _ = jslu.gssvx(
        jslu.Options(iter_refine=jslu.IterRefine.NOREFINE), ja, bs[:, 0])
    return a, _port(a), jlu, bs, xs


def _backlog(srv, cols, flush=True):
    tickets = [srv.submit(c) for c in cols]
    srv.start()
    if flush:
        srv.flush()
    out = []
    for t in tickets:
        try:
            out.append(("ok", t.result(120)))
        except Exception as e:          # noqa: BLE001
            out.append(("err", e))
    return out


def _batch_widths(srv):
    """Record the width of every batch the server dispatches."""
    widths = []
    base = srv._dispatch

    def spy(segs, *a, **kw):
        widths.append(sum(hi - lo for _, lo, hi in segs))
        return base(segs, *a, **kw)

    srv._dispatch = spy
    return widths


COUNTERS = ("requests", "columns", "batches", "errors", "shed",
            "deadline_miss", "poisoned_columns", "refined", "swaps",
            "refactors", "scrub_runs", "scrub_failures", "queue_depth",
            "mean_batch_columns", "max_batch", "closed", "draining",
            "quarantined")


@pytest.mark.parametrize("max_batch", [0, 4, 3])
def test_backlog_batches_and_stats_equal_jax(factored, max_batch):
    """The same backlog (requests of 1, 3, 1 and 2 columns) submitted
    before start() — coalesced, or split at a batch cap — makes the same
    batches of the same widths and the same counters in both packages;
    X agrees at the device-vs-host gate."""
    a, lu, jlu, bs, xs = factored
    cols = [bs[:, 0], bs[:, 1:4], bs[:, 4], bs[:, 5:7]]
    runs = []
    for cls, h in ((SolveServer, lu), (JaxServer, jlu)):
        srv = cls(h, max_batch=max_batch, max_wait_s=0.05, start=False)
        got_w = _batch_widths(srv)
        out = _backlog(srv, cols, flush=False)
        srv.close()
        st = srv.stats()
        runs.append((got_w, {k: st[k] for k in COUNTERS}, out))
    (pw, pst, pout), (jw, jst, jout) = runs
    assert pw == jw
    assert pst == jst
    assert sum(pw) == 7 and (max_batch == 0) == (len(pw) == 1)
    for (pk, px), (jk, jx) in zip(pout, jout):
        assert pk == jk == "ok"
        np.testing.assert_allclose(px, np.asarray(jx), rtol=RTOL, atol=ATOL)


def test_poisson3d_backlog_equals_jax():
    a, ja = gallery.poisson3d(8), jgal.poisson3d(8)
    rng = np.random.default_rng(3)
    bs = a.matvec(rng.standard_normal((a.n_rows, 6)))
    _, jlu, _, _ = jslu.gssvx(
        jslu.Options(iter_refine=jslu.IterRefine.NOREFINE), ja, bs[:, 0])
    outs = []
    for cls, h in ((SolveServer, _port(a)), (JaxServer, jlu)):
        srv = cls(h, start=False, max_wait_s=0.05)
        outs.append(_backlog(srv, [bs[:, :2], bs[:, 2], bs[:, 3:]]))
        assert srv.stats()["batches"] == 1
        srv.close()
    for (pk, px), (jk, jx) in zip(*outs):
        assert pk == jk == "ok"
        np.testing.assert_allclose(px, np.asarray(jx), rtol=RTOL, atol=ATOL)


def test_concurrent_submitters_and_transpose(factored):
    a, lu, jlu, bs, xs = factored
    srv = SolveServer(lu, max_wait_s=0.002)
    errs, got = [], {}

    def client(j0):
        try:
            for j in range(j0, 70, 4):
                got[j] = srv.solve(bs[:, j], timeout=60)
        except Exception as e:      # noqa: BLE001
            errs.append(e)

    th = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in th:
        t.start()
    for t in th:
        t.join(60)
    srv.close()
    assert not errs and len(got) == 70
    for j, x in got.items():
        np.testing.assert_allclose(x, xs[:, j], rtol=1e-8, atol=1e-10)
    tsrv = SolveServer(lu, trans=True, max_wait_s=0.0)
    jt = JaxServer(jlu, trans=True, max_wait_s=0.0)
    np.testing.assert_allclose(tsrv.solve(bs[:, 0], 60),
                               np.asarray(jt.solve(bs[:, 0], 60)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tsrv.solve(bs[:, 0], 60),
                                  lu.solve_factored_trans(bs[:, 0]))
    tsrv.close()
    jt.close()


def test_from_bundle_serves_with_fact_zero(factored, tmp_path):
    """A bundle-loaded server serves a fixed backlog bit for bit as the
    live one, without factoring, on the device it was asked for."""
    a, lu, jlu, bs, xs = factored
    d = str(tmp_path / "h")
    slt.save_lu(lu, d)
    live = _backlog(SolveServer(lu, start=False), [bs[:, :3], bs[:, 3]])
    srv = SolveServer.from_bundle(d, device=CPU, start=False)
    assert srv.source == d and srv.device.type == "cpu"
    assert srv.lu.a is None
    loaded = _backlog(srv, [bs[:, :3], bs[:, 3]])
    for (k1, x1), (k2, x2) in zip(live, loaded):
        assert k1 == k2 == "ok" and np.array_equal(x1, x2)
    srv.close()
    with pytest.raises(RuntimeError, match="cuda"):
        SolveServer.from_bundle(d, device="cuda")


def test_submit_validation_and_batch_error(factored):
    a, lu, jlu, bs, xs = factored
    srv = SolveServer(lu, start=False)
    with pytest.raises(SuperLUError, match="does not fit"):
        srv.submit(np.ones(a.n_rows + 1))
    with pytest.raises(SuperLUError, match="FACTORED"):
        SolveServer(dataclasses.replace(lu, numeric=None))

    def broken(mat):
        raise RuntimeError("device fault")

    srv._solve = broken
    out = _backlog(srv, [bs[:, 0], bs[:, 1]])
    assert all(k == "err" and "device fault" in str(e) for k, e in out)
    assert srv.stats()["errors"] == 1
    srv.close()


# ---------------------------------------------------------------------------
# admission control, deadlines
# ---------------------------------------------------------------------------

def test_shed_at_the_same_queue_max(factored):
    a, lu, jlu, bs, xs = factored
    shed = []
    for cls, h in ((SolveServer, lu), (JaxServer, jlu)):
        srv = cls(h, queue_max=5, start=False)
        idx = []
        for j in range(4):
            try:
                srv.submit(bs[:, j:j + 2])
            except ServeOverloadError as e:
                idx.append((j, e.pending_cols, e.queue_max, e.reason))
            except Exception as e:      # the JAX package's error class
                idx.append((j, e.pending_cols, e.queue_max, e.reason))
        shed.append((idx, srv.stats()["shed"], srv.stats()["queue_depth"]))
        srv.close()
    assert shed[0] == shed[1]
    assert shed[0][0][0][:2] == (2, 4)


def test_deadline_expiry_under_stalled_dispatcher(factored):
    a, lu, jlu, bs, xs = factored
    srv = SolveServer(lu, deadline_s=0.08, start=False)
    t = srv.submit(bs[:, 0])
    t0 = time.perf_counter()
    with pytest.raises(ServeDeadlineError) as ei:
        t.result(10)
    assert time.perf_counter() - t0 < 5.0
    assert ei.value.waited_s >= 0.08 and ei.value.columns == 1
    assert srv.stats()["deadline_miss"] == 1
    assert srv.stats()["queue_depth"] == 0
    dead = [srv.submit(bs[:, j]) for j in range(2)]
    time.sleep(0.12)
    srv.start()
    live = srv.submit(bs[:, 3])
    np.testing.assert_allclose(live.result(60), xs[:, 3], rtol=1e-8,
                               atol=1e-10)
    for d in dead:
        with pytest.raises(ServeDeadlineError):
            d.result(10)
    assert srv.stats()["deadline_miss"] == 3
    srv.close()


# ---------------------------------------------------------------------------
# poisoned requests, the BERR gate
# ---------------------------------------------------------------------------

def test_poisoned_column_isolates_bitwise(factored):
    """One NaN column inside a coalesced 16-column batch: that ticket
    alone fails, naming its column; every neighbour is bit for bit the
    unpoisoned dispatch of the same batch width."""
    a, lu, jlu, bs, xs = factored
    ref = _backlog(SolveServer(lu, start=False),
                   [bs[:, j] for j in range(16)])
    bp = bs.copy()
    bp[:, 6] = np.nan
    srv = SolveServer(lu, start=False)
    got = _backlog(srv, [bp[:, j] for j in range(16)])
    for j, (kind, val) in enumerate(got):
        if j == 6:
            assert kind == "err" and isinstance(val, ServePoisonedError)
            assert val.columns == [0] and val.batch_columns == 16
        else:
            assert kind == "ok" and np.array_equal(val, ref[j][1]), j
    assert srv.stats()["poisoned_columns"] == 1
    assert srv.stats()["batches"] == 1
    srv.close()


def test_poison_inside_wide_request_and_bisection(factored):
    a, lu, jlu, bs, xs = factored
    wide = bs[:, :5].copy()
    wide[:, 3] = np.inf
    srv = SolveServer(lu, start=False)
    got = _backlog(srv, [wide, bs[:, 10]])
    assert got[0][0] == "err" and got[0][1].columns == [3]
    np.testing.assert_allclose(got[1][1], xs[:, 10], rtol=1e-8, atol=1e-10)
    srv.close()
    # a batch solve that RAISES is bisected to the offending column; the
    # healthy ones are re-served at the original width, bit for bit
    ref = _backlog(SolveServer(lu, start=False), [bs[:, j] for j in range(8)])
    srv = SolveServer(lu, start=False)
    base = srv._solve

    def strict(mat):
        out = np.asarray(base(mat))
        if not np.isfinite(out).all():
            raise NumericBreakdownError(where="serve-test")
        return out

    srv._solve = strict
    bp = [bs[:, j].copy() for j in range(8)]
    bp[5][0] = np.nan
    got = _backlog(srv, bp)
    for j, (kind, val) in enumerate(got):
        if j == 5:
            assert isinstance(val, ServePoisonedError)
        else:
            assert kind == "ok" and np.array_equal(val, ref[j][1])
    srv.close()


def test_chaos_poison_and_slow_client(factored, monkeypatch):
    a, lu, jlu, bs, xs = factored
    monkeypatch.setenv("SLU_TPU_CHAOS", "poison_rhs=2")
    srv = SolveServer(lu, start=False)
    got = _backlog(srv, [bs[:, j] for j in range(4)])
    assert [k for k, _ in got] == ["ok", "ok", "err", "ok"]
    srv.close()
    monkeypatch.setenv("SLU_TPU_CHAOS", "slow_client=1,secs=0.2")
    srv = SolveServer(lu, max_wait_s=0.0)
    t0 = srv.submit(bs[:, 0])
    t1 = srv.submit(bs[:, 1])
    t_start = time.perf_counter()
    t1.result(30)
    assert time.perf_counter() - t_start >= 0.2
    t0.result(30)
    srv.close()


def test_serve_ir_rung_delivers_at_the_gate(factored):
    """float32 factors: every ticket's berr starts above
    berr_target(float64); the per-ticket IR rung delivers each at or under
    it, as the JAX server's does."""
    a, lu64, jlu, bs, xs = factored
    gate = float(tols.berr_target("float64"))
    lu = _port(a, factor_dtype="float32")
    _, jlu32, _, _ = jslu.gssvx(
        jslu.Options(iter_refine=jslu.IterRefine.NOREFINE,
                     factor_dtype="float32"), jgal.poisson2d(10), bs[:, 0])
    from superlu_dist_tpu_torch.refine.ir import request_berrs
    for cls, h in ((SolveServer, lu), (JaxServer, jlu32)):
        srv = cls(h, berr_max=gate, start=False)
        tickets = [srv.submit(bs[:, j]) for j in range(4)]
        srv.start()
        srv.flush()
        for j, t in enumerate(tickets):
            x = np.asarray(t.result(60))
            assert request_berrs(a, bs[:, j], x)[0] <= gate
            assert t.rungs and t.rungs[0]["rung"] == "serve-ir"
            assert t.rungs[0]["berr_before"] > gate
        assert srv.stats()["refined"] == 4
        srv.close()
    bare = dataclasses.replace(lu, a=None)
    with pytest.raises(SuperLUError, match="original matrix"):
        SolveServer(bare, berr_max=gate, start=False)


# ---------------------------------------------------------------------------
# swap, refactor, scrub
# ---------------------------------------------------------------------------

def test_swap_to_the_same_factors_changes_no_x(factored, tmp_path):
    a, lu, jlu, bs, xs = factored
    d = str(tmp_path / "same")
    slt.save_lu(lu, d)
    srv = SolveServer(lu, max_wait_s=0.0)
    before = srv.solve(bs[:, :3], 60)
    srv.swap(d)
    assert srv.source == d and srv.stats()["swaps"] == 1
    assert np.array_equal(srv.solve(bs[:, :3], 60), before)
    with pytest.raises(SuperLUError, match="same-sized"):
        srv.swap(_port(gallery.poisson2d(11)))
    srv.close()


def test_server_refactor_bitwise_the_port_refactor(factored):
    """server.refactor(new values) serves what slt.refactor + the
    handle's solve_factored give, bit for bit; pattern drift is refused
    with the old handle serving."""
    a, lu, jlu, bs, xs = factored
    vals = a.data * (1.0 + 0.05 * np.random.default_rng(4).random(a.nnz))
    live = _port(a)
    srv = SolveServer(live, max_wait_s=0.0)
    old = srv.lu
    srv.refactor(vals)
    assert srv.lu is not old and old.numeric is live.numeric
    mine = _port(a)
    slt.refactor(mine, vals)
    assert np.array_equal(srv.solve(bs[:, :2], 60),
                          mine.solve_factored(bs[:, :2]))
    assert srv.stats()["refactors"] == 1 and srv.stats()["swaps"] == 1
    with pytest.raises(PatternMismatchError):
        srv.refactor(vals[:-1])
    srv.close()


def _flip(numeric, g):
    lp, up = numeric.fronts[g]
    buf = lp.clone()
    buf.view(-1).view(torch.uint8)[7] ^= 0xFF
    numeric.fronts[g] = (buf, up)


def test_corrupted_resident_panel_quarantines(factored, tmp_path):
    a, lu, jlu, bs, xs = factored
    srv = SolveServer(_port(a), scrub_s=3600, start=False)
    assert srv.scrub_now() == []
    queued = srv.submit(bs[:, 0])
    _flip(srv.lu.numeric, 0)
    with pytest.raises(FactorCorruptError) as ei:
        srv.scrub_now()
    assert ei.value.groups == [0]
    with pytest.raises(FactorCorruptError):
        queued.result(10)
    with pytest.raises(FactorCorruptError):
        srv.submit(bs[:, 1])
    st = srv.stats()
    assert st["quarantined"] and st["scrub_failures"] == 1
    d = str(tmp_path / "fresh")
    slt.save_lu(lu, d)
    srv.swap(d)
    srv.start()
    np.testing.assert_allclose(srv.solve(bs[:, 0], 60), xs[:, 0],
                               rtol=1e-8, atol=1e-10)
    assert srv.scrub_now() == [] and not srv.stats()["quarantined"]
    srv.close()


def test_chaos_corrupt_panel_and_scrub_thread(factored, monkeypatch,
                                              tmp_path):
    a, lu, jlu, bs, xs = factored
    d = str(tmp_path / "b")
    slt.save_lu(lu, d)
    monkeypatch.setenv("SLU_TPU_CHAOS", "corrupt_panel=1")
    monkeypatch.setenv("SLU_TPU_FLIGHTREC", str(tmp_path / "fr-%p.json"))
    flightrec._reset()
    try:
        srv = SolveServer.from_bundle(d, device=CPU, scrub_s=3600,
                                      start=False)
        with pytest.raises(FactorCorruptError) as ei:
            srv.scrub_now()
        assert ei.value.groups == [1] and d in ei.value.source
        assert ei.value.flightrec_dump
        srv.close()
    finally:
        flightrec._reset()
    monkeypatch.delenv("SLU_TPU_CHAOS")
    srv = SolveServer(_port(a), scrub_s=0.05, start=False)
    end = time.perf_counter() + 10
    while srv.stats()["scrub_runs"] < 2:
        assert time.perf_counter() < end, "scrub thread never ran"
        time.sleep(0.02)
    srv.close()
    assert srv.stats()["scrub_failures"] == 0


# ---------------------------------------------------------------------------
# drain / close, observability, locks
# ---------------------------------------------------------------------------

def test_drain_and_close_semantics(factored):
    a, lu, jlu, bs, xs = factored
    srv = SolveServer(lu, start=False)
    ts = [srv.submit(bs[:, j]) for j in range(3)]
    srv.start()
    assert srv.drain(timeout=60)
    for t, j in zip(ts, range(3)):
        np.testing.assert_allclose(t.result(10), xs[:, j], rtol=1e-8,
                                   atol=1e-10)
    with pytest.raises(ServeOverloadError) as ei:
        srv.submit(bs[:, 0])
    assert ei.value.reason == "draining"
    srv.resume()
    srv.solve(bs[:, 0], 60)
    srv.close()
    with pytest.raises(ServerClosedError):
        srv.submit(bs[:, 0])
    with pytest.raises(ServerClosedError):
        srv.swap(lu)
    stranded = SolveServer(lu, start=False)
    t = stranded.submit(bs[:, 0])
    stranded.close()
    with pytest.raises(ServerClosedError):
        t.result(5)


def test_serve_metrics_and_request_spans(factored, tmp_path):
    a, lu, jlu, bs, xs = factored
    m = metrics.Metrics()
    prev_m = metrics.install(m)
    t = trace.Tracer(str(tmp_path / "t.json"))
    prev_t = trace.install(t)
    try:
        srv = SolveServer(lu, queue_max=3, start=False)
        _backlog(srv, [bs[:, 0], bs[:, 1:3]])
        with pytest.raises(ServeOverloadError):
            srv.submit(bs[:, :4])
        srv.close()
    finally:
        trace.install(prev_t)
        metrics.install(prev_m)
    t.close()
    snap = m.snapshot()
    c, h = snap["counters"], snap["histograms"]
    assert c["slu_serve_requests_total"] == 2.0
    assert c["slu_serve_columns_total"] == 3.0
    assert c["slu_serve_batches_total"] == 1.0
    assert c['slu_serve_shed_total{reason="queue_full"}'] == 1.0
    for k in ("slu_serve_request_seconds", "slu_serve_batch_fill",
              "slu_serve_queue_wait_seconds"):
        assert h[k]["count"] >= 1, k
    ev = json.load(open(tmp_path / "t.json"))["traceEvents"]
    names = [e["name"] for e in ev]
    assert "serve-batch" in names and "device-solve" in names
    reqs = [e for e in ev if e["name"] == "request"]
    assert len(reqs) == 2 and all(e["cat"] == "request" for e in reqs)
    assert {"queue_wait", "dispatch", "device"} <= set(names)


@pytest.mark.locks
def test_serve_cycle_clean_under_the_lock_verifier(factored, monkeypatch):
    a, lu, jlu, bs, xs = factored
    monkeypatch.setenv("SLU_TPU_VERIFY_LOCKS", "1")
    lockwatch._reset()
    try:
        srv = SolveServer(lu, max_wait_s=0.001, scrub_s=0.02)
        assert isinstance(srv._lock, lockwatch.InstrumentedLock)
        errs = []

        def client(j0):
            try:
                for j in range(j0, 24, 3):
                    srv.solve(bs[:, j], timeout=60)
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        th = [threading.Thread(target=client, args=(s,)) for s in range(3)]
        for t in th:
            t.start()
        for t in th:
            t.join(60)
        srv.drain(10)
        srv.close()
        assert not errs
        assert "SolveServer._lock" in str(lockwatch.order_graph()) or \
            lockwatch._WATCH.checks > 0
    finally:
        lockwatch._reset()
