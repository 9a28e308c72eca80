"""Kernel spans and the profile record of the port's factor executors
(superlu_dist_tpu_torch/obs/kernelspans.py), held against the JAX
package's on tests/test_obs.py's small plan (poisson2d(6), float64),
both packages under a file ``Tracer``:

* the stream at "group": one ``lu b{b} m{m} w{w} u{u}`` kernel span and
  one ``issue g{gi}`` dispatch span a group, each group's span agreeing
  with the JAX one on level, batch, m, w, u, structural flops (exactly),
  the GEMM tier and host; ``last_profile`` one entry a group with the
  JAX keys, ``last_dispatch_seconds`` set;
* the stream at "level": the aggregate spans agree with the JAX
  ``_call_levels`` spans;
* fused: one ``factor-fused`` span (structural flops = plan.flops) and an
  ``issue fused`` dispatch span, as the JAX fused program's;
* mega: ``padded_batch`` the JAX mega executor's rung, ≥ the batch;
* the host share: the leading spans ``host=True``, as in JAX;
* the grid (1×2 gloo ranks, tests/torch_mesh_cases.py): a span a group
  on both ranks for the 2-D, fused and mega executors, a span a wave at
  "level", the aggregate ``factor-{name}`` / ``factor-spmd`` spans;
* the off path: no tracer, or the flight recorder alone, makes no clock
  and leaves ``last_profile`` None; traced fronts equal untraced ones bit
  for bit;
* scripts/mfu_report_torch.py ranks the kernel sinks of a traced port
  FACT, and exits 1 on an empty trace; scripts/trace_cost_torch.py
  exits 2 without a card;
* a record's process id is read once, and again in a forked child.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from superlu_dist_tpu.obs import trace as jtrace

import torch_mesh_cases as cases
from superlu_dist_tpu_torch.interop import plan_from_reference
from superlu_dist_tpu_torch.numeric import stream as tstream
from superlu_dist_tpu_torch.numeric.fused import FusedExecutor
from superlu_dist_tpu_torch.numeric.mega import MegaExecutor
from superlu_dist_tpu_torch.numeric.stream import StreamExecutor
from superlu_dist_tpu_torch.obs import flightrec
from superlu_dist_tpu_torch.obs import trace as ttrace
from superlu_dist_tpu_torch.testing.ranks import run_mesh_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the args every kernel span carries (JAX stream.py:670-690)
SPAN_ARGS = ("level", "batch", "padded_batch", "m", "w", "u", "gemm_prec",
             "host", "aggregate", "executed_flops", "structural_flops",
             "padding")
#: the keys of a last_profile entry (JAX stream.py:594)
PROFILE_KEYS = {"level", "batch", "m", "w", "u", "host", "seconds", "gflop"}
_PLAN = {}


def _plans():
    """tests/test_obs.py's small plan in both packages, and its values."""
    if not _PLAN:
        from test_obs import _small_plan
        jplan, avals = _small_plan()
        _PLAN.update(jplan=jplan, plan=plan_from_reference(jplan),
                     avals=np.asarray(avals))
    return _PLAN["jplan"], _PLAN["plan"], _PLAN["avals"]


def _events(path):
    return json.load(open(path))["traceEvents"]


def _jax_run(tmp_path, make):
    """A JAX executor (``make(jplan)``) called once under a file tracer:
    (the executor, its trace events)."""
    jplan, _, avals = _plans()
    path = str(tmp_path / "jax.json")
    t = jtrace.Tracer(path)
    prev = jtrace.install(t)
    try:
        ex = make(jplan)
        ex(jnp.asarray(avals), jnp.asarray(0.0))
    finally:
        jtrace.install(prev)
        t.close()
    return ex, _events(path)


def _port_call(ex):
    _, _, avals = _plans()
    return ex(torch.as_tensor(avals), torch.tensor(0.0, dtype=torch.float64))


def _port_run(tmp_path, ex):
    """The port's executor ``ex`` called once under a file tracer: (its
    fronts, its trace events)."""
    path = str(tmp_path / "port.json")
    t = ttrace.Tracer(path)
    prev = ttrace.install(t)
    try:
        fronts, _ = _port_call(ex)
    finally:
        ttrace.install(prev)
        t.close()
    return fronts, _events(path)


def _cat(events, cat):
    return [e for e in events if e["cat"] == cat]


def _lu_spans(events):
    return sorted((e for e in _cat(events, "kernel")
                   if e["name"].startswith("lu ")), key=lambda e: e["ts"])


@pytest.mark.parametrize("field", ["level", "batch", "m", "w", "u",
                                   "structural_flops", "gemm_prec", "host"])
def test_stream_group_spans_agree_with_jax(tmp_path, field):
    from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
    _, jev = _jax_run(tmp_path, lambda p: JStream(p, "float64"))
    _, plan, _ = _plans()
    _, tev = _port_run(tmp_path, StreamExecutor(plan, torch.float64, "cpu"))
    js, ts = _lu_spans(jev), _lu_spans(tev)
    assert len(ts) == len(js) == len(plan.groups)
    for j, t, g in zip(js, ts, plan.groups):
        assert t["args"][field] == j["args"][field], (field, g)
        assert t["name"] == f"lu b{g.batch} m{g.m} w{g.w} u{g.u}"


def test_stream_group_spans_counts_and_profile(tmp_path):
    from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
    jex, jev = _jax_run(tmp_path, lambda p: JStream(p, "float64"))
    _, plan, _ = _plans()
    ex = StreamExecutor(plan, torch.float64, "cpu")
    _, tev = _port_run(tmp_path, ex)
    n = len(plan.groups)
    assert len(_cat(tev, "kernel")) == len(_cat(jev, "kernel")) == n
    assert len(_cat(tev, "dispatch")) == len(_cat(jev, "dispatch")) == n
    assert [e["name"] for e in _cat(tev, "dispatch")] == \
        [f"issue g{gi}" for gi in range(n)]
    for e, je in zip(_lu_spans(tev), _lu_spans(jev)):
        args = e["args"]
        assert set(SPAN_ARGS) <= set(args)
        assert args["aggregate"] is False
        # real batches: executed == structural, padding 1 (the JAX
        # stream's pow-2 padded batches execute at least as much)
        assert args["padded_batch"] == args["batch"]
        assert args["executed_flops"] == args["structural_flops"] > 0
        assert args["padding"] == 1.0
        assert je["args"]["executed_flops"] >= je["args"]["structural_flops"]
        assert e["dur"] >= 0
    assert len(ex.last_profile) == len(jex.last_profile) == n
    for p, jp in zip(ex.last_profile, jex.last_profile):
        assert set(p) == set(jp) == PROFILE_KEYS
        assert p["level"] == jp["level"] and p["m"] == jp["m"]
        assert p["gflop"] == jp["gflop"] and p["seconds"] >= 0
    assert ex.last_dispatch_seconds > 0
    assert jex.last_dispatch_seconds > 0


def test_stream_level_spans_agree_with_jax(tmp_path):
    from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
    jex, jev = _jax_run(tmp_path,
                        lambda p: JStream(p, "float64", granularity="level"))
    _, plan, _ = _plans()
    ex = StreamExecutor(plan, torch.float64, "cpu", granularity="level")
    _, tev = _port_run(tmp_path, ex)
    js, ts = _lu_spans(jev), _lu_spans(tev)
    assert len(ts) == len(js) == len(ex.waves()) > 1
    for j, t in zip(js, ts):
        for k in ("level", "batch", "m", "w", "u", "gemm_prec", "host",
                  "aggregate"):
            assert t["args"][k] == j["args"][k], k
        assert t["args"]["aggregate"] is True
        assert t["args"]["structural_flops"] == pytest.approx(
            j["args"]["structural_flops"], rel=1e-14)
        # the port's waves run their real batches, the JAX ones pow-2
        # padded batches
        assert t["args"]["padded_batch"] == t["args"]["batch"] \
            <= j["args"]["padded_batch"]
        assert t["args"]["executed_flops"] == t["args"]["structural_flops"]
        assert t["name"] == (f"lu b{t['args']['batch']} m{t['args']['m']} "
                             f"w{t['args']['w']} u{t['args']['u']}")
    assert [e["name"] for e in _cat(tev, "dispatch")] == \
        [e["name"] for e in _cat(jev, "dispatch")]
    assert len(ex.last_profile) == len(jex.last_profile)
    for p, jp in zip(ex.last_profile, jex.last_profile):
        assert set(p) == set(jp) == PROFILE_KEYS | {"aggregate"}
        assert {k: p[k] for k in ("level", "batch", "m", "w", "u", "host")} \
            == {k: jp[k] for k in ("level", "batch", "m", "w", "u", "host")}
    assert ex.last_dispatch_seconds > 0


def test_fused_span_agrees_with_jax(tmp_path):
    from superlu_dist_tpu.numeric.factor import make_factor_fn
    _, jev = _jax_run(tmp_path, lambda p: make_factor_fn(p, "float64"))
    jplan, plan, _ = _plans()
    ex = FusedExecutor(plan, torch.float64, "cpu")
    _, tev = _port_run(tmp_path, ex)
    kernels, jkernels = _cat(tev, "kernel"), _cat(jev, "kernel")
    assert len(kernels) == 1 and kernels[0]["name"] == "factor-fused"
    args = kernels[0]["args"]
    assert args["aggregate"] and args["structural_flops"] == plan.flops
    assert args == jkernels[0]["args"]
    assert [e["name"] for e in _cat(tev, "dispatch")] == ["issue fused"]
    assert _cat(tev, "dispatch")[0]["args"] == \
        _cat(jev, "dispatch")[0]["args"]
    assert len(ex.last_profile) == 1 and ex.last_profile[0]["aggregate"]


def test_mega_spans_padded_batch(tmp_path):
    from superlu_dist_tpu.numeric.mega import MegaExecutor as JMega
    _, jev = _jax_run(tmp_path, lambda p: JMega(p, "float64"))
    _, plan, _ = _plans()
    ex = MegaExecutor(plan, torch.float64, "cpu")
    _, tev = _port_run(tmp_path, ex)
    ts, js = _lu_spans(tev), _lu_spans(jev)
    assert len(ts) == len(js) == len(plan.groups)
    for t, j, g in zip(ts, js, plan.groups):
        args = t["args"]
        assert args["padded_batch"] >= args["batch"] == g.batch
        assert args["padded_batch"] == j["args"]["padded_batch"]
        assert args["executed_flops"] == j["args"]["executed_flops"]
        assert args["padding"] == j["args"]["padding"] >= 1.0
    assert [p["batch"] for p in ex.last_profile] == \
        [t["args"]["padded_batch"] for t in ts]


def test_host_share_spans(tmp_path):
    from superlu_dist_tpu.numeric.stream import StreamExecutor as JStream
    _, plan, _ = _plans()
    cut = 1e12                  # every level on the host
    jex, jev = _jax_run(tmp_path,
                        lambda p: JStream(p, "float64", host_flops=cut))
    ex = StreamExecutor(plan, torch.float64, "cpu", host_flops=cut)
    _, tev = _port_run(tmp_path, ex)
    ts, js = _lu_spans(tev), _lu_spans(jev)
    assert ex.host_levels > 0
    assert [t["args"]["host"] for t in ts] == \
        [j["args"]["host"] for j in js]
    assert ts[0]["args"]["host"] is True
    assert [p["host"] for p in ex.last_profile] == \
        [p["host"] for p in jex.last_profile]


@pytest.mark.parametrize("tracer", ["none", "flightrec"])
def test_off_path_makes_no_clock(tmp_path, monkeypatch, tracer):
    """With no tracer, or the flight recorder alone (not a profiling
    tracer), the executors make no KernelClock — hence no CUDA event —
    and leave last_profile None; the fronts are those of a traced call
    bit for bit."""
    _, plan, _ = _plans()
    exs = [StreamExecutor(plan, torch.float64, "cpu"),
           StreamExecutor(plan, torch.float64, "cpu", granularity="level"),
           FusedExecutor(plan, torch.float64, "cpu"),
           MegaExecutor(plan, torch.float64, "cpu")]

    def refuse(*a, **k):
        raise AssertionError("a clock on the off path")
    prev = ttrace.install(flightrec.FlightRecorder() if tracer ==
                          "flightrec" else ttrace.NULL_TRACER)
    try:
        assert not ttrace.get_tracer().profiling
        with monkeypatch.context() as m:
            m.setattr(tstream, "KernelClock", refuse)
            plain = [_port_call(ex)[0] for ex in exs]
    finally:
        ttrace.install(prev)
    for ex, fronts in zip(exs, plain):
        assert ex.last_profile is None
        assert ex.last_dispatch_seconds > 0
        traced, _ = _port_run(tmp_path, ex)
        assert cases._equal_fronts(traced, fronts)
        assert len(ex.last_profile) >= 1


_GRID = {}


def _grid_spans():
    """The 1×2 gloo grid's traced runs (tests/torch_mesh_cases.py
    ``traced_grid_spans``) on the small plan, both ranks."""
    if not _GRID:
        import tempfile
        _, plan, avals = _plans()
        tmp = tempfile.mkdtemp(prefix="slt_gridspans_")
        _GRID.update(run_mesh_ranks(2, cases.traced_grid_spans, plan, avals,
                                    0.0, os.path.join(tmp, "t"),
                                    timeout=240))
    return _GRID


@pytest.mark.parametrize("executor", ["group", "fused", "mega"])
def test_grid_spans_a_group_on_both_ranks(executor):
    out = _grid_spans()
    _, plan, _ = _plans()
    name = {"group": "mesh-stream", "fused": "mesh-fused",
            "mega": "mesh-mega"}[executor]
    for r in (0, 1):
        rec = out[r][executor]
        lu = [(n, a) for n, _, a in rec["kernel"] if n.startswith("lu ")]
        agg = [a for n, _, a in rec["kernel"] if n == f"factor-{name}"]
        assert len(lu) == len(plan.groups) and len(agg) == 1
        assert agg[0]["aggregate"] and agg[0]["local_flops"] > 0
        for (n, a), g in zip(lu, plan.groups):
            assert set(SPAN_ARGS) <= set(a)
            assert a["batch"] == g.batch and a["level"] == g.level
            assert a["padded_batch"] >= a["batch"]
            assert {"owned", "columns", "local_flops"} <= set(a)
        assert sum(a["owned"] for _, a in lu) > 0
        assert len(rec["profile"]) == len(plan.groups)
        assert rec["profile_before"] is None and rec["equal"]
        assert f"issue {name}" in rec["dispatch"]


def test_grid_spans_a_wave_at_level():
    out = _grid_spans()
    for r in (0, 1):
        rec = out[r]["level"]
        lu = [a for n, _, a in rec["kernel"] if n.startswith("lu ")]
        assert len(lu) == rec["units"] == len(rec["profile"])
        assert all(a["aggregate"] for a in lu) and rec["equal"]
        assert sum(1 for d in rec["dispatch"] if d.startswith("issue lvl")) \
            == rec["units"]


def test_grid_spmd_aggregate_span():
    out = _grid_spans()
    for r in (0, 1):
        rec = out[r]["spmd"]
        assert [n for n, _, _ in rec["kernel"]] == ["factor-spmd"]
        assert rec["kernel"][0][2]["aggregate"] and rec["equal"]


def _traced_fact(tmp_path):
    """A small traced port FACT (gssvx on poisson2d(12) on the CPU) and
    the path of its trace."""
    import superlu_dist_tpu_torch as slt
    from superlu_dist_tpu_torch.models.gallery import poisson2d
    path = str(tmp_path / "fact.json")
    t = ttrace.Tracer(path)
    prev = ttrace.install(t)
    try:
        a = poisson2d(12)
        _, _, _, info = slt.gssvx(slt.Options(executor="stream"), a,
                                  np.ones(a.n_rows), device="cpu")
    finally:
        ttrace.install(prev)
        t.close()
    assert info == 0
    return path


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
def test_mfu_report_torch_ranks_kernel_sinks(tmp_path, fmt):
    path = _traced_fact(tmp_path)
    if fmt == "jsonl":
        path = path[:-5] + ".jsonl"
    n = sum(1 for e in _events(str(tmp_path / "fact.json"))
            if e["cat"] == "kernel")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "mfu_report_torch.py"),
         str(tmp_path / "none.jsonl"), path],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert f"kernel trace (structured trace): {n} entries" in res.stdout
    assert "top sinks" in res.stdout
    assert res.stdout.count(" ms ") >= min(n, 12)


def test_mfu_report_torch_empty_trace(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text("")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "mfu_report_torch.py"),
         str(tmp_path / "none.jsonl"), str(empty)],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 1
    assert "no trace rows found" in res.stderr


def test_tracer_records_the_pid_of_a_forked_child(tmp_path):
    """Records carry the process id read once, and read again in a
    forked child: a child's spans are its own."""
    if not hasattr(os, "fork"):
        pytest.skip("no fork on this platform")
    path = str(tmp_path / "child.json")
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            t = ttrace.Tracer(path)
            t.complete("child", "phase", 0.0, 0.0)
            t.close()
            code = 0
        finally:
            os._exit(code)
    _, status = os.waitpid(pid, 0)
    assert os.WEXITSTATUS(status) == 0
    events = _events(path)
    assert {e["pid"] for e in events} == {pid}
    mine = ttrace.Tracer(str(tmp_path / "parent.json"))
    mine.complete("parent", "phase", 0.0, 0.0)
    mine.close()
    assert {e["pid"] for e in _events(str(tmp_path / "parent.json"))} == \
        {os.getpid()}


def test_trace_cost_script_needs_the_card(tmp_path):
    """scripts/trace_cost_torch.py measures on the card only: without
    one it exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "trace_cost_torch.py"),
         "6", "1"], capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path))
    assert res.returncode == 2 and not res.stdout
    assert "needs a CUDA device" in res.stderr
