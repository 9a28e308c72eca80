"""The port's observability, knob registry, lock-order verifier and chaos
harness on the CPU, held against the JAX package's on the same inputs:
every knob the port registers has the JAX kind and default; the same
span sequence gives the same chrome-trace events; the same metric
operations give an equal snapshot and equal Prometheus text; a flight
recorder dump has the same keys (the build census included); the same
inverted lock acquisition raises LockOrderError; chaos specs parse to
equal plans; the serving errors carry the same messages.  A traced port
solve shows its ``device-solve`` / ``solve-d2h`` spans, a traced
factorization its phase, schedule and dispatch spans, and the driver and
refactor feed the metrics registry."""

import json
import os
import re
import threading

import numpy as np
import pytest

from superlu_dist_tpu.obs import flightrec as jflightrec
from superlu_dist_tpu.obs import metrics as jmetrics
from superlu_dist_tpu.obs import slo as jslo
from superlu_dist_tpu.obs import trace as jtrace
from superlu_dist_tpu.testing import chaos as jchaos
from superlu_dist_tpu.utils import errors as jerrors
from superlu_dist_tpu.utils import lockwatch as jlockwatch
from superlu_dist_tpu.utils import options as joptions

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.obs import flightrec, metrics, slo, trace
from superlu_dist_tpu_torch.testing import chaos
from superlu_dist_tpu_torch.utils import errors, lockwatch, options

pytestmark = pytest.mark.obs


# ---------------------------------------------------------------------------
# knob registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(options.KNOB_REGISTRY))
def test_knob_has_the_jax_kind_and_default(name):
    mine = options.KNOB_REGISTRY[name]
    ref = joptions.KNOB_REGISTRY[name]
    assert (mine.kind, mine.default, mine.group, mine.choices) == \
        (ref.kind, ref.default, ref.group, ref.choices)


_PORT_SOURCE = "\n".join(
    open(os.path.join(dirpath, f)).read()
    for dirpath, _, files in os.walk(os.path.dirname(slt.__file__))
    for f in files if f.endswith(".py"))


@pytest.mark.parametrize("name", sorted(options.KNOB_REGISTRY))
def test_knob_is_read_by_the_port(name):
    # a registered knob is one the port reads: an env_* reader or the
    # strict check's own environ read names it
    pat = r'(env_(int|float|str|flag)|os\.environ\.get)\(\s*"' + name + '"'
    assert re.search(pat, _PORT_SOURCE)


def test_jax_only_knob_is_unknown_under_strict_env(monkeypatch):
    # the JAX package's legacy profile flag is read by nothing here
    assert "SLU_TPU_PROFILE" in joptions.KNOB_REGISTRY
    assert "SLU_TPU_PROFILE" not in options.KNOB_REGISTRY
    monkeypatch.setenv("SLU_TPU_STRICT_ENV", "1")
    monkeypatch.setenv("SLU_TPU_PROFILE", "1")
    monkeypatch.setattr(options, "_strict_checked", False)
    with pytest.raises(options.UnknownKnobError, match="SLU_TPU_PROFILE"):
        options.env_int("SLU_TPU_SOLVE_NRHS_MAX")


@pytest.mark.parametrize("name,raw", [
    ("SLU_TPU_SOLVE_NRHS_MAX", "64"), ("SLU_TPU_SOLVE_NRHS_MAX", "x"),
    ("SLU_TPU_SERVE_MAX_WAIT_MS", "0.5"), ("SLU_TPU_VERIFY_LOCKS", "off"),
    ("SLU_TPU_VERIFY_LOCKS", "1"), ("SLU_TPU_FLEET_KIND", "process")])
def test_env_readers_parse_as_jax(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    kind = options.KNOB_REGISTRY[name].kind
    read = {"int": "env_int", "float": "env_float", "str": "env_str",
            "flag": "env_flag"}[kind]
    assert getattr(options, read)(name) == getattr(joptions, read)(name)


def test_unregistered_and_strict_knobs_raise(monkeypatch):
    with pytest.raises(options.UnknownKnobError):
        options.env_int("SLU_TPU_NOT_A_KNOB")
    monkeypatch.setenv("SLU_TPU_STRICT_ENV", "1")
    monkeypatch.setenv("SLU_TPU_SERVE_MAX_BATCHH", "3")
    monkeypatch.setattr(options, "_strict_checked", False)
    with pytest.raises(options.UnknownKnobError, match="did you mean "
                       "SLU_TPU_SERVE_MAX_BATCH"):
        options.env_int("SLU_TPU_SERVE_MAX_BATCH")
    table = options.knob_table_md(groups=("serve",))
    assert table.count("\n") == 1 + sum(
        k.group == "serve" for k in options.KNOB_REGISTRY.values())


def test_device_solver_reads_the_nrhs_knobs(monkeypatch):
    a = gallery.poisson2d(6)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    from superlu_dist_tpu_torch.solve.device import DeviceSolver
    assert DeviceSolver(lu.numeric).splan.nrhs_bucket_set[-1] == 1024
    monkeypatch.setenv("SLU_TPU_SOLVE_NRHS_MAX", "16")
    assert DeviceSolver(lu.numeric).splan.nrhs_bucket_set[-1] == 16


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _drive_spans(mod, path):
    t = mod.Tracer(path)
    with t.span("EQUIL", cat="phase", n=5):
        with t.span("issue g0", cat="dispatch", group=0) as sp:
            sp.set(level=2)
        t.complete("solve-d2h", "comm", 1.0, 0.001, op="d2h", bytes=80)
    with t.span("request", cat="request", trace_id="t1"):
        pass
    t.close()
    return t


def _events(path):
    doc = json.load(open(path))
    return [(e["name"], e["cat"], e["depth"], e.get("args"))
            for e in doc["traceEvents"] if e["name"] != "clock-anchor"]


def test_tracer_events_equal_jax(tmp_path):
    _drive_spans(trace, str(tmp_path / "port.json"))
    _drive_spans(jtrace, str(tmp_path / "jax.json"))
    mine, ref = _events(tmp_path / "port.json"), _events(tmp_path / "jax.json")
    assert sorted(mine, key=str) == sorted(ref, key=str)
    assert len(mine) == 4
    lines = open(tmp_path / "port.jsonl").read().splitlines()
    assert len(lines) == 5 and json.loads(lines[0])["name"] == "clock-anchor"
    assert trace.CATEGORIES == jtrace.CATEGORIES


def test_null_and_tee_tracers(tmp_path):
    assert trace.NULL_TRACER.span("x") is trace.NULL_SPAN
    t = trace.Tracer(str(tmp_path / "a.json"))
    fr = flightrec.FlightRecorder(str(tmp_path / "fr.json"), depth=32)
    tee = trace.TeeTracer(t, fr, trace.NULL_TRACER)
    with tee.span("FACT", cat="phase"):
        pass
    tee.close()
    assert [e[2] for e in fr._ring] == ["FACT"]
    assert any(e[0] == "FACT" for e in _events(tmp_path / "a.json"))


@pytest.fixture
def traced(tmp_path):
    t = trace.Tracer(str(tmp_path / "t.json"))
    prev = trace.install(t)
    yield t, tmp_path / "t.json"
    trace.install(prev)


def test_traced_solve_shows_device_spans(traced):
    t, path = traced
    a = gallery.poisson2d(8)
    b = a.matvec(np.ones(a.n_rows))
    x, lu, st, info = slt.gssvx(slt.Options(executor="stream"), a, b,
                                device="cpu")
    lu.solve_factored(np.stack([b, b, b], 1))
    t.close()
    names = [e[0] for e in _events(path)]
    for want in ("EQUIL", "ROWPERM", "COLPERM", "FACT", "SOLVE", "REFINE",
                 "schedule", "issue g0", "device-solve", "solve-d2h"):
        assert want in names, want
    ev = {e[0]: e for e in _events(path)}
    assert ev["device-solve"][1] == "kernel"
    assert ev["solve-d2h"][1] == "comm"
    assert ev["issue g0"][3]["group"] == 0
    solves = [e for e in _events(path) if e[0] == "device-solve"]
    assert solves[-1][3]["nrhs"] == 3 and solves[-1][3]["padded_nrhs"] == 4


def test_nonfinite_solve_probe_span(traced):
    t, path = traced
    a = gallery.poisson2d(6)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    b = np.ones((a.n_rows, 2))
    b[3, 1] = np.nan
    lu.solve_factored(b)
    t.close()
    probes = [e for e in _events(path) if e[0] == "solve-probe"]
    assert probes and probes[0][1] == "verify"
    assert probes[0][3]["nonfinite"] == 1


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _drive_metrics(mod):
    m = mod.Metrics()
    m.inc("slu_serve_requests_total", 1.0)
    m.inc("slu_serve_requests_total", 2.0)
    m.inc("slu_serve_shed_total", 1.0, reason="draining")
    m.set("slu_serve_queue_depth", 7.0)
    for v in (1e-4, 3e-3, 0.2, 5.0, 500.0):
        m.observe("slu_serve_request_seconds", v)
    m.observe("slu_lock_hold_seconds", 2e-6, lock="SolveServer._lock")
    return m


def test_metrics_snapshot_and_prometheus_equal_jax():
    mine, ref = _drive_metrics(metrics), _drive_metrics(jmetrics)
    assert mine.snapshot() == ref.snapshot()
    assert mine.to_prometheus() == ref.to_prometheus()
    assert json.loads(mine.to_json()) == json.loads(ref.to_json())


def test_metrics_merge_snapshot_delta_equal_jax():
    out = []
    for mod in (metrics, jmetrics):
        child = _drive_metrics(mod)
        first = child.snapshot()
        child.inc("slu_serve_requests_total", 4.0)
        child.observe("slu_serve_request_seconds", 0.05)
        root = mod.Metrics()
        root.merge_snapshot(first)
        root.merge_snapshot(child.snapshot(), base=first)
        out.append(root.snapshot())
    assert out[0] == out[1]
    assert out[0]["counters"]["slu_serve_requests_total"] == 7.0


def test_metrics_disabled_path_and_reduce(monkeypatch, tmp_path):
    assert not metrics.NULL_METRICS.enabled
    assert metrics.NULL_METRICS.snapshot() == {}
    assert metrics.NULL_METRICS.reduce(comm=None) == {}
    # one rank: the reduction over a TreeComm is the registry itself, as
    # the JAX package's (parallel/treecomm.py; several ranks:
    # tests/test_torch_treecomm.py)
    from superlu_dist_tpu.parallel.treecomm import TreeComm as JTreeComm
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    red = []
    for mod, tcls in ((metrics, TreeComm), (jmetrics, JTreeComm)):
        with tcls(f"/slt_obs_red_{os.getpid()}", 1, 0, max_len=64) as tc:
            red.append(_drive_metrics(mod).reduce(tc))
    assert red[0] == red[1]
    assert red[0]["counter:slu_serve_requests_total"] == {
        "sum": 3.0, "min": 3.0, "max": 3.0, "avg": 3.0}
    path = tmp_path / "m.json"
    monkeypatch.setenv("SLU_TPU_METRICS", str(path))
    metrics._reset()
    try:
        m = metrics.get_metrics()
        assert m.enabled and m.export_path == str(path)
        m.inc("slu_x_total")
        assert m.dump_now() and json.load(open(path))["counters"] == {
            "slu_x_total": 1.0}
    finally:
        metrics._reset()


@pytest.fixture
def metered():
    m = metrics.Metrics()
    prev = metrics.install(m)
    yield m
    metrics.install(prev)


def test_driver_and_refactor_metrics(metered):
    a = gallery.poisson2d(8)
    b = a.matvec(np.ones(a.n_rows))
    x, lu, st, info = slt.gssvx(slt.Options(), a, b, device="cpu")
    slt.refactor(lu, a.data * 1.5)
    c = metered.snapshot()["counters"]
    assert c['slu_factorizations_total{schedule="dataflow"}'] == 2.0
    assert c['slu_gemm_precision_total{tier="default"}'] == 2.0
    assert c["slu_refactor_total"] == 1.0
    assert c["slu_refactor_adopted_total"] == 1.0
    assert "slu_schedule_groups" in metered.snapshot()["gauges"]


def test_ladder_rungs_feed_metrics(metered):
    a = gallery.hilbert(8)
    b = a.matvec(np.ones(a.n_rows))
    slt.gssvx(slt.Options(factor_dtype="float32"), a, b, device="cpu")
    c = metered.snapshot()["counters"]
    rungs = [k for k in c if k.startswith("slu_recovery_rungs_total")]
    assert rungs, c
    assert any(k.startswith("slu_recovery_rung_seconds")
               for k in metered.snapshot()["histograms"])


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _dump(mod, path):
    fr = mod.FlightRecorder(str(path), depth=16)
    for i in range(20):
        fr.complete(f"issue g{i}", "dispatch", 1.0 + i, 0.5, group=i)
    fr.event("refactor-adopted", cat="refactor", step=0)
    return json.load(open(fr.dump("unit", detail="why")))


def test_flightrec_dump_has_the_jax_keys(tmp_path):
    mine = _dump(flightrec, tmp_path / "port.json")
    ref = _dump(jflightrec, tmp_path / "jax.json")
    # both carry their build census under "compile"
    assert set(mine) == set(ref)
    assert mine["total_events"] == ref["total_events"] == 21
    assert mine["dropped_events"] == ref["dropped_events"] == 5
    assert [e["name"] for e in mine["events"]] == \
        [e["name"] for e in ref["events"]]


def test_flightrec_dump_on_structured_error(tmp_path, monkeypatch):
    monkeypatch.setenv("SLU_TPU_FLIGHTREC", str(tmp_path / "fr-%p.json"))
    flightrec._reset()
    try:
        err = errors.NumericBreakdownError(3, 12, where="unit")
        assert err.flightrec_dump and os.path.exists(err.flightrec_dump)
        doc = json.load(open(err.flightrec_dump))
        assert doc["reason"] == "NumericBreakdownError"
        assert "supernode 3" in doc["detail"]
        perr = errors.ServePoisonedError([1], batch_columns=4,
                                         stages={"device": 1.5})
        doc = json.load(open(perr.flightrec_dump))
        assert doc["extra"]["ticket_stages"] == {"device": 1.5}
    finally:
        flightrec._reset()


# ---------------------------------------------------------------------------
# lock-order verifier
# ---------------------------------------------------------------------------

def _inversion(mod, err_mod):
    mod._reset()
    a, b = mod.make_lock("A"), mod.make_lock("B")
    with a:
        with b:
            pass

    box = {}

    def other():
        try:
            with b:
                with a:
                    pass
        except err_mod.LockOrderError as e:
            box["err"] = e

    th = threading.Thread(target=other)
    th.start()
    th.join(10)
    graph = mod.order_graph()
    mod._reset()
    return box.get("err"), graph


def test_lock_inversion_raises_as_jax(monkeypatch):
    monkeypatch.setenv("SLU_TPU_VERIFY_LOCKS", "1")
    mine, g1 = _inversion(lockwatch, errors)
    ref, g2 = _inversion(jlockwatch, jerrors)
    assert mine is not None and ref is not None
    assert (mine.outer, mine.inner) == (ref.outer, ref.inner) == ("B", "A")
    assert g1 == g2 == {"A": ["B"]}
    assert "lock-order inversion" in str(mine)


def test_lockwatch_off_path_is_a_plain_lock(monkeypatch):
    monkeypatch.delenv("SLU_TPU_VERIFY_LOCKS", raising=False)
    lockwatch._reset()
    assert type(lockwatch.make_lock("x")) is type(threading.Lock())
    assert lockwatch._WATCH is None and lockwatch.order_graph() == {}


# ---------------------------------------------------------------------------
# chaos harness
# ---------------------------------------------------------------------------

SPECS = ["kill_group=5", "kill_group=5,signal=term", "nan_supernode=3",
         "kill_rank=1@group=3", "poison_rhs=17", "slow_client=2,secs=1",
         "corrupt_panel=0", "kill_replica=1@batch=3", "kill_replica=0",
         "quarantine_replica=1", "slow_replica=0,secs=0.5",
         "kill_refactor@step=2", "poison_values=3", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_jax(spec):
    mine = chaos.parse_chaos_spec(spec)
    ref = jchaos.parse_chaos_spec(spec)
    assert vars(mine) == vars(ref)
    for prop in ("armed", "serve_armed", "fleet_armed", "refactor_armed"):
        assert getattr(mine, prop) == getattr(ref, prop)


def test_chaos_helpers(tmp_path):
    with pytest.raises(ValueError, match="unknown chaos"):
        chaos.parse_chaos_spec("kill_grup=1")
    for mod, name in ((chaos, "p"), (jchaos, "j")):
        f = tmp_path / name
        f.write_bytes(bytes(range(64)))
        mod.corrupt_file(str(f), mode="flip")
    assert (tmp_path / "p").read_bytes() == (tmp_path / "j").read_bytes()
    d = chaos.CountdownDeadline(2)
    d.poll()
    d.poll()
    with pytest.raises(errors.DeadlineExceededError):
        d.poll()
    w = chaos.HangWatchdog(60.0).arm()
    w.disarm()
    monkey = chaos.ChaosMonkey(chaos.parse_chaos_spec("poison_rhs=5"))
    b = np.ones((4, 3))
    out = monkey.poison_submit(b, 4)
    assert np.isnan(out[:, 1]).all() and np.isfinite(np.delete(out, 1, 1)).all()
    assert monkey.poison_submit(b, 10) is b


def test_chaos_nan_supernode_trips_the_sentinel(monkeypatch):
    a = gallery.poisson2d(8)
    monkeypatch.setenv("SLU_TPU_CHAOS", "nan_supernode=2")
    with pytest.raises(errors.NumericBreakdownError) as ei:
        slt.gssvx(slt.Options(executor="stream"), a, np.ones(a.n_rows),
                  device="cpu")
    assert ei.value.supernode >= 0


def test_chaos_poison_values_rolls_refactor_back(monkeypatch):
    a = gallery.poisson2d(8)
    _, lu, _, _ = slt.gssvx(slt.Options(), a, np.ones(a.n_rows),
                            device="cpu")
    before = lu.numeric
    monkeypatch.setenv("SLU_TPU_CHAOS", "poison_values=3")
    with pytest.raises(errors.RefactorRollbackError):
        slt.refactor(lu, a.data * 2.0)
    assert lu.numeric is before


# ---------------------------------------------------------------------------
# SLO layer and the serving errors
# ---------------------------------------------------------------------------

def _drive_slo(mod):
    acc = mod.LatencyAccounter()
    for k, s in ((1, 0.001), (1, 0.004), (4, 0.02), (70, 0.3), (1, 2.0)):
        acc.observe(k, s)
    acc.observe(1, 0.01, klass="fleet")
    ev = mod.SLOEvaluator(p99_ms=5.0, budget=0.1)
    return acc.snapshot(), acc.summary(), ev.evaluate(acc)


def test_slo_accounter_and_evaluator_equal_jax():
    assert _drive_slo(slo) == _drive_slo(jslo)
    assert [slo.nrhs_bucket(k) for k in (1, 7, 8, 600, 5000)] == \
        [jslo.nrhs_bucket(k) for k in (1, 7, 8, 600, 5000)]
    # the collective merge over one rank returns the accounter's own
    # summary, as the JAX package's
    from superlu_dist_tpu.parallel.treecomm import TreeComm as JTreeComm
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    red = []
    for mod, tcls in ((slo, TreeComm), (jslo, JTreeComm)):
        acc = mod.LatencyAccounter()
        for k, sec in ((1, 0.001), (4, 0.02), (70, 0.3)):
            acc.observe(k, sec)
        with tcls(f"/slt_slo_red_{os.getpid()}", 1, 0, max_len=64) as tc:
            red.append((acc.reduce(tc), acc.summary()))
    assert red[0] == red[1] and red[0][0] == red[0][1]


def test_ticket_context_stages_sum():
    ctx = slo.TicketContext("s1", 10.0)
    ctx.stage("queue_wait", 10.0, 0.002).stage("device", 10.002, 0.003)
    assert ctx.stages_ms() == pytest.approx({"queue_wait": 2.0,
                                             "device": 3.0})
    child = slo.TicketContext("s2", 11.0, parent=slo.parent_ref(
        ctx.trace_id))
    assert child.trace_id == ctx.trace_id
    assert slo.NULL_TICKET.stages_ms() == {}


ERRS = [
    ("ServerClosedError", ("closed",), {}),
    ("ServeOverloadError", (3, 10, 12), {}),
    ("ServeOverloadError", (3, 10, 12), {"reason": "draining"}),
    ("ServeDeadlineError", (0.5, 0.75, 2), {}),
    ("ServePoisonedError", ([4, 1],), {"batch_columns": 8,
                                        "where": "serve-batch"}),
    ("FactorCorruptError", ([2, 0],), {"source": "bundle /x"}),
    ("ReplicaFailureError", (1, [7, 3]), {"cause": "unit", "pid": 99,
                                          "kind": "process"}),
    ("DeployRollbackError", ("k", "/b", "canary"), {
        "replica": 1, "rolled_back": [0], "cause": "berr"}),
    ("RefactorRollbackError", ("k", "deploy"), {"replica": 0,
                                                "rolled_back": [1]}),
    ("LockOrderError", ("A", "B", "x.py:1", "y.py:2"), {}),
]


@pytest.mark.parametrize("name,args,kw", ERRS, ids=[e[0] for e in ERRS])
def test_serving_errors_match_jax(name, args, kw):
    mine = getattr(errors, name)(*args, **kw)
    ref = getattr(jerrors, name)(*args, **kw)
    assert isinstance(mine, errors.SuperLUError)
    if name != "RefactorRollbackError":
        # the JAX message names its docs/SERVING.md chapter
        assert str(mine) == str(ref)
    attrs = {k: v for k, v in vars(ref).items() if k != "flightrec_dump"}
    assert {k: vars(mine)[k] for k in attrs} == attrs
