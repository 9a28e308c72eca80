"""The port's build census and retrace sentinel (obs/compilestats.py,
numeric/stream.RetraceSentinel) held against the JAX package's.

* The same seeded records, announcements and audit notes give equal
  ``census()``, ``block()`` and ``pending()`` (the JAX disk hits come
  from its cache-directory rule, the port's are said by the caller).
* The native host library's build records a miss, then a hit, and
  ``fresh_seconds`` counts the miss only — a build the JAX census has
  no counterpart of (a deliberate difference).
* The report's compile lines, the flight recorder's ``compile`` key, the
  driver's ``slu_compile_*`` counters, ``stats.compile["program_audit"]``
  and ``Stats.retraces`` on the CPU.
* ``RetraceSentinel.record``: total, 32-event window, stderr line, the
  ``verify`` span and ``slu_retraces_total`` as the JAX one; the
  executors' ``retrace_end``; the eager group stream's empty census
  against the JAX stream's per-key builds (a deliberate difference).

Card-only halves (captures, mega's pending keys, the solve's buckets, a
forced recapture) are in tests/test_torch_cuda.py.
"""

import json

import numpy as np
import pytest

from superlu_dist_tpu.numeric import stream as jstream
from superlu_dist_tpu.obs import compilestats as jcs
from superlu_dist_tpu.obs import flightrec as jflightrec
from superlu_dist_tpu.obs import metrics as jmetrics
from superlu_dist_tpu.utils.stats import Stats as JaxStats

import superlu_dist_tpu_torch as slt
from superlu_dist_tpu_torch import native
from superlu_dist_tpu_torch.models import gallery
from superlu_dist_tpu_torch.numeric import factor
from superlu_dist_tpu_torch.numeric import stream as tstream
from superlu_dist_tpu_torch.obs import compilestats as tcs
from superlu_dist_tpu_torch.obs import flightrec, metrics
from superlu_dist_tpu_torch.utils import programaudit
from superlu_dist_tpu_torch.utils.stats import Stats

SITES = ("stream._level_fn", "make_factor_fn", "mega._kernel",
         "solve.device", "mesh_graphs.segment")


def _feed(seed, jax_cs, port_cs, cache_dir=None):
    """The same seeded sequence into both censuses: announcements,
    records (site, key, seconds, n_args, builds, hit) and audit notes;
    returns the marker taken half-way."""
    rng = np.random.default_rng(seed)
    keys = [f"lu b{2 ** k} m{8 * k} w{4 * k} u{2 * k}" for k in range(1, 7)]
    announced = sorted(set(rng.choice(keys, 4).tolist()))
    for cs in (jax_cs, port_cs):
        cs.announce("mega._kernel", announced)
    if cache_dir is not None:
        jax_cs.note_cache_dir(str(cache_dir))
        (cache_dir / "seed").write_text("0")
        jax_cs.note_cache_dir(str(cache_dir))
    mark = None
    for i in range(24):
        if i == 12:
            mark = (jax_cs.marker(), port_cs.marker())
        site = SITES[int(rng.integers(len(SITES)))]
        key = keys[int(rng.integers(len(keys)))]
        sec = float(rng.uniform(0.001, 2.0))
        n_args, builds = int(rng.integers(0, 7)), int(rng.integers(1, 3))
        hit = None
        if cache_dir is not None:
            hit = bool(rng.random() < 0.5)
            if not hit:            # a miss writes a new cache entry
                (cache_dir / f"entry{i}").write_text("x")
        jax_cs.record(site, key, 100.0 + i, sec, n_args=n_args,
                      builds=builds)
        port_cs.record(site, key, 100.0 + i, sec, n_args=n_args,
                       builds=builds, persistent_hit=hit)
    # a bucket the audits noted, built fresh
    if cache_dir is not None:
        (cache_dir / "entry_last").write_text("x")
    jax_cs.record("mega._kernel", keys[0], 130.0, 0.5)
    port_cs.record("mega._kernel", keys[0], 130.0, 0.5,
                   persistent_hit=False if cache_dir is not None else None)
    for i, key in enumerate(keys[:3]):
        stats = {"dead_bytes": 1000 * (i + 1), "findings": 0,
                 "baked_const_bytes": 64 * i}
        for cs, donated in ((jax_cs, "donated_bytes"),
                            (port_cs, "donated_bytes")):
            cs.audit_note("mega._kernel", key, dict(
                stats, **{donated: 500 * (i + 1)}))
            cs.audit_note("mega._kernel", key + "#dtypes", {"findings": 0})
            cs.audit_note("mega._kernel", key + "#sharding", {
                "peak_bytes_est": 4096 * (i + 1),
                "replicated_bytes": 128 * i, "findings": 0})
    return mark


def _drop_cache_dir(block):
    return {k: v for k, v in block.items() if k != "cache_dir"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_cache", [False, True])
def test_census_block_pending_equal_jax(seed, with_cache, tmp_path):
    jax_cs, port_cs = jcs.CompileStats(), tcs.CompileStats()
    cache = tmp_path / "cache" if with_cache else None
    if cache is not None:
        cache.mkdir()
    jm, pm = _feed(seed, jax_cs, port_cs, cache)
    assert jm == pm
    assert port_cs.census() == jax_cs.census()
    assert port_cs.census(since=pm) == jax_cs.census(since=jm)
    for since, top in ((0, 8), (pm, 3), (0, 16)):
        assert _drop_cache_dir(port_cs.block(since=since, top=top)) == \
            _drop_cache_dir(jax_cs.block(since=jm if since else 0, top=top))
    assert port_cs.pending() == jax_cs.pending()
    assert port_cs.audit_block() == jax_cs.audit_block()
    assert port_cs.total_seconds(pm) == jax_cs.total_seconds(jm)
    # the sharding notes' peaks land on the matching census rows
    assert any("peak_bytes_est" in row for row in port_cs.census())
    if with_cache:
        assert port_cs.block()["persistent_hits"] > 0
    port_cs._reset()
    jax_cs._reset()
    assert port_cs.block() == {**jax_cs.block(),
                               "cache_dir": port_cs.block()["cache_dir"]}


def test_port_in_place_bytes_count_as_donated():
    """The port's SLU111 stats say in-place bytes; the block sums them
    under the JAX name."""
    cs = tcs.CompileStats()
    cs.audit_note("fused.run_groups", "fused g3",
                  {"dead_bytes": 400, "inplace_bytes": 300, "findings": 0})
    blk = cs.audit_block()
    assert blk["donated_bytes"] == 300 and blk["donation_coverage_pct"] == 75.0


def test_census_row_carries_the_peak_of_programs_captured_under_it():
    """Two programs (float32 and float64) captured under one census key
    keep a note each; the census row carries the larger peak."""
    cs = tcs.CompileStats()
    build = ("stream._level_fn", "level3 g2")
    cs.record(*build, 0.0, 0.1)
    cs.record(*build, 0.0, 0.2)
    for tag, peak in (("float32 tf32", 4096), ("float64 ieee", 8192)):
        cs.audit_note("stream.run_groups", f"level3 g2 {tag}#sharding",
                      {"peak_bytes_est": peak, "findings": 0}, build=build)
    assert cs.audit_block()["programs"] == 2
    (row,) = cs.census()
    assert (row["n"], row["peak_bytes_est"]) == (2, 8192)


def test_record_emits_trace_span(monkeypatch):
    from superlu_dist_tpu_torch.obs import trace
    spans = []

    class Rec:
        enabled = True

        def complete(self, name, cat, t0, dur, **kw):
            spans.append((name, cat, kw))

    monkeypatch.setattr(trace, "_tracer", Rec())
    cs = tcs.CompileStats()
    rec = cs.record("kernels.build", "abc", 1.0, 0.5, persistent_hit=True)
    assert (rec.site, rec.persistent_hit) == ("kernels.build", True)
    assert spans == [("compile kernels.build", "compile",
                      {"key": "abc", "n_args": 0, "builds": 1,
                       "persistent_hit": True})]
    # the JAX block's shape: no persistent cache directory in the port
    assert cs.block()["cache_dir"] is None


def test_native_build_records_a_miss_then_a_hit(tmp_path, monkeypatch):
    """The one build a CPU test can watch for real: into an empty build
    root the library is compiled (a miss), then found (a hit)."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "host")
    cs = tcs.COMPILE_STATS
    mark = cs.marker()
    first = native.build()
    second = native.build()
    assert first == second and first.exists()
    recs = cs.records[mark:]
    assert [(r.site, r.persistent_hit) for r in recs] == [
        ("native.build", False), ("native.build", True)]
    assert recs[0].key == recs[1].key == first.parent.name
    blk = cs.block(since=mark)
    assert blk["builds"] == 2 and blk["persistent_hits"] == 1
    assert blk["fresh_seconds"] == round(recs[0].seconds, 4) > 0
    assert [(r["site"], r["n"], r["persistent_hits"])
            for r in blk["census"]] == [("native.build", 2, 1)]


def test_report_compile_lines_match_jax():
    jax_cs, port_cs = jcs.CompileStats(), tcs.CompileStats()
    _feed(3, jax_cs, port_cs)
    lines = []
    for cls, cs in ((Stats, port_cs), (JaxStats, jax_cs)):
        st = cls()
        st.compile = cs.block()
        st.utime["FACT"] = 1.0
        lines.append([ln for ln in st.report().splitlines()
                      if ln.startswith(("    compile", "      "))])
    assert lines[0] == lines[1]
    assert lines[0][0].startswith("    compile  builds")
    assert len(lines[0]) == 4
    # an empty census prints no compile line in either
    for cls in (Stats, JaxStats):
        st = cls()
        st.compile = tcs.CompileStats().block()
        assert "compile  builds" not in st.report()


def test_report_retrace_line():
    st = Stats()
    assert "recaptures" not in st.report()
    st.retraces = 2
    assert "    UNEXPECTED graph recaptures: 2 " in st.report()


def test_flightrec_dump_carries_compile(tmp_path):
    cs = tcs.COMPILE_STATS
    mark = cs.marker()
    cs.record("solve.device", "solve n8 nrhs1 fused", 0.0, 0.25)
    docs = []
    for mod, name in ((flightrec, "port.json"), (jflightrec, "jax.json")):
        fr = mod.FlightRecorder(str(tmp_path / name), depth=4)
        docs.append(json.load(open(fr.dump("unit"))))
    mine, ref = docs
    assert set(mine["compile"]) == set(ref["compile"])
    assert mine["compile"] == json.loads(json.dumps(cs.block(top=16),
                                                    default=str))
    assert any(r["key"] == "solve n8 nrhs1 fused"
               for r in mine["compile"]["census"])
    del cs.records[mark:]


def test_gssvx_metrics_carry_compile_counters(monkeypatch):
    monkeypatch.setenv("SLU_TPU_METRICS", "1")
    metrics._reset()
    tcs.COMPILE_STATS._reset()       # no audit notes of earlier tests
    try:
        a = gallery.poisson2d(8)
        x, lu, st, info = slt.gssvx(slt.Options(), a,
                                    a.matvec(np.ones(a.n_rows)),
                                    device="cpu")
        c = metrics.get_metrics().snapshot()["counters"]
        assert c["slu_compile_builds_total"] == float(st.compile["builds"])
        assert c["slu_compile_seconds_total"] == st.compile["seconds"]
        # the eager CPU factorization builds nothing
        assert st.compile["builds"] == 0 and st.compile["census"] == []
        assert st.compile["program_audit"] is None
    finally:
        metrics._reset()


def _agrees_with_auditors(pblk, blk):
    """The census's audit block (the notes summed, JAX schema) against
    the auditors' own (programaudit.audit_block), count for count."""
    assert pblk["programs"] == (blk["programs_audited"]
                                + blk["programs_dtypes_audited"]
                                + blk["programs_sharding_audited"])
    assert pblk["programs_sharding_audited"] == \
        blk["programs_sharding_audited"]
    assert pblk["dead_bytes"] == blk["dead_bytes"]
    assert pblk["donated_bytes"] == blk["inplace_bytes"]
    assert pblk["donation_coverage_pct"] == blk["inplace_coverage_pct"]
    assert pblk["baked_const_bytes"] == blk["baked_const_bytes"]
    assert pblk["replicated_bytes"] == blk["replicated_bytes"]
    assert pblk["peak_bytes_est"] == blk["peak_bytes_est"]


def test_gssvx_program_audit_block(monkeypatch):
    monkeypatch.setenv("SLU_TPU_VERIFY_PROGRAMS", "1")
    programaudit._reset()
    tcs.COMPILE_STATS._reset()
    try:
        a = gallery.poisson2d(6)
        lu, bvals, st = slt.analyze(slt.Options(executor="stream"), a,
                                    device="cpu")
        assert slt.factorize_numeric(lu, bvals, st) == 0
        blk = programaudit.audit_block()
        assert blk["programs"] > 0
        assert st.compile["program_audit"] == \
            tcs.COMPILE_STATS.audit_block()
        _agrees_with_auditors(st.compile["program_audit"], blk)
        # each audited program noted in the census under its own label
        notes = tcs.COMPILE_STATS._audits
        assert {k for k in programaudit.get_auditor().audited} <= set(notes)
    finally:
        programaudit._reset()
        tcs.COMPILE_STATS._reset()


def test_float32_and_float64_level_audits_one_block(monkeypatch, tmp_path):
    """A float32 and a float64 level executor of one plan audited in one
    process: each wave program keeps its own note (its label carries the
    dtype and tier, where the census key ``level{l} g{n}`` does not), and
    stats.compile, the flight recorder's ``compile`` key and the auditors'
    own block agree."""
    import torch
    for knob in ("SLU_TPU_VERIFY_PROGRAMS", "SLU_TPU_VERIFY_DTYPES",
                 "SLU_TPU_VERIFY_SHARDING"):
        monkeypatch.setenv(knob, "1")
    programaudit._reset()
    tcs.COMPILE_STATS._reset()
    try:
        a = gallery.poisson2d(6)
        lu, bvals, st = slt.analyze(slt.Options(executor="stream"), a,
                                    device="cpu")
        for dt in (torch.float32, torch.float64):
            tstream.StreamExecutor(lu.plan, dt, "cpu", granularity="level")(
                torch.as_tensor(bvals).to(dt), torch.tensor(1e-300))
        labels = [k for s, k in programaudit.get_auditor().audited
                  if s == "stream.run_groups"]
        waves = len(tstream.StreamExecutor(lu.plan, torch.float64, "cpu",
                                           granularity="level").waves())
        assert len([k for k in labels if "float32" in k]) == waves
        assert len([k for k in labels if "float64" in k]) == waves
        assert slt.factorize_numeric(lu, bvals, st) == 0
        blk = programaudit.audit_block()
        pblk = tcs.COMPILE_STATS.audit_block()
        assert st.compile["program_audit"] == pblk
        _agrees_with_auditors(pblk, blk)
        fr = flightrec.FlightRecorder(str(tmp_path / "fr.json"), depth=4)
        doc = json.load(open(fr.dump("unit")))
        assert doc["compile"]["program_audit"] == pblk
    finally:
        programaudit._reset()
        tcs.COMPILE_STATS._reset()


class _Spans:
    enabled = True

    def __init__(self):
        self.spans = []

    def complete(self, name, cat, t0, dur, **kw):
        self.spans.append((name, cat, dur, kw))


def test_retrace_sentinel_record_matches_jax(capsys):
    out = []
    for mod, mmod in ((tstream, metrics), (jstream, jmetrics)):
        m = mmod.Metrics()
        prev = mmod.install(m)
        try:
            sent, tr = mod.RetraceSentinel(), _Spans()
            for i in range(40):
                sent.record(f"StreamExecutor[level]#{i % 3}", 1 + i % 2, tr)
            err = capsys.readouterr().err.splitlines()
            out.append((sent.total, sent.events, tr.spans,
                        m.snapshot()["counters"], err))
        finally:
            mmod.install(prev)
    (pt, pe, ps, pc, perr), (jt, je, js, jc, jerr) = out
    assert pt == jt == sum(1 + i % 2 for i in range(40))
    assert pe == je and len(pe) == 32
    assert [(n, c, d, kw) for n, c, d, kw in ps] == \
        [(n, c, d, kw) for n, c, d, kw in js]
    assert ps[0][:2] == ("retrace-sentinel", "verify")
    assert pc == jc
    assert 'slu_retraces_total{factory="StreamExecutor[level]#0"}' in pc
    assert len(perr) == len(jerr) == 40
    for p, j in zip(perr, jerr):
        assert p.split(" unexpected")[0] == j.split(" unexpected")[0]
        assert p.split(" in ")[1].split()[0] == j.split(" in ")[1].split()[0]


class _Ex:
    captures = 0
    sentinel_warm = False
    last_kernel_builds = last_retraces = 0


def test_retrace_end_counts_only_a_warmed_executor(capsys):
    sent = tstream.RETRACE_SENTINEL
    total0 = sent.total
    ex = _Ex()
    ex.captures = 3                 # the first call captures: warm-up
    tstream.retrace_end(ex, 0, "FusedExecutor[level]")
    assert (ex.last_kernel_builds, ex.last_retraces) == (3, 0)
    assert sent.total == total0 and ex.sentinel_warm
    tstream.retrace_end(ex, 3, "FusedExecutor[level]")
    assert (ex.last_kernel_builds, ex.last_retraces) == (0, 0)
    ex.captures = 4                 # a warmed executor captured again
    tstream.retrace_end(ex, 3, "FusedExecutor[level]")
    assert (ex.last_kernel_builds, ex.last_retraces) == (1, 1)
    assert sent.total == total0 + 1
    assert sent.events[-1] == ("FusedExecutor[level]", 1)
    assert "[SLU106] retrace sentinel: 1 unexpected CUDA graph" in \
        capsys.readouterr().err


def test_stats_retraces_from_a_recapturing_executor():
    """A warmed fused executor whose call captures again (simulated on
    the CPU, where nothing is captured) shows in Stats.retraces and the
    report."""
    a = gallery.poisson2d(6)
    b = a.matvec(np.ones(a.n_rows))
    x, lu, st, info = slt.gssvx(slt.Options(executor="fused"), a, b,
                                device="cpu")
    assert st.retraces == 0
    (ex,) = factor.cached_executors(lu.plan)
    assert ex.sentinel_warm and ex.captures == 0
    orig = ex._call_waves

    def recapture(*args, **kw):
        ex.captures += 1
        return orig(*args, **kw)

    ex._call_waves = recapture
    st2 = slt.Stats()
    x2, lu2, st2, info = slt.gssvx(slt.Options(executor="fused",
                                               fact=slt.Fact.SamePattern),
                                   a, b, lu=lu, stats=st2)
    assert st2.retraces == 1 and ex.last_retraces == 1
    assert "UNEXPECTED graph recaptures: 1" in st2.report()


def test_group_stream_census_is_empty_unlike_jax():
    """The deliberate difference: the JAX group stream jit-compiles one
    kernel per shape key (census site ``stream._kernel``); the port's
    runs eagerly and records no per-key build."""
    from superlu_dist_tpu import Options as JaxOptions
    from superlu_dist_tpu import gssvx as jax_gssvx
    from superlu_dist_tpu.models.gallery import poisson2d as jpoisson2d
    a, ja = gallery.poisson2d(6), jpoisson2d(6)
    mark = tcs.COMPILE_STATS.marker()
    x, lu, st, info = slt.gssvx(slt.Options(executor="stream"), a,
                                a.matvec(np.ones(a.n_rows)), device="cpu")
    assert st.compile["census"] == []
    assert tcs.COMPILE_STATS.block(since=mark)["builds"] == 0
    (ex,) = factor.cached_executors(lu.plan)
    assert ex.captures == 0 and ex.sentinel_warm
    # the JAX stream's first call of each key is a build (its census
    # counts a key once a process: forget the keys other tests built)
    jstream._CENSUSED_KEYS.clear()
    jmark = jcs.COMPILE_STATS.marker()
    jax_gssvx(JaxOptions(executor="stream"), ja,
              ja.matvec(np.ones(ja.n_rows)))
    sites = {r["site"] for r in jcs.COMPILE_STATS.census(since=jmark)}
    assert "stream._kernel" in sites
