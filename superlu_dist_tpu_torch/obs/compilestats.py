"""Build census — per-site, per-key accounting of every build the port makes.

Port of the JAX package's ``obs/compilestats.py``.  There a record is one
jit compile; here it is one of the port's three kinds of build:

* ``kernels.build`` — the ``nvcc`` build of ``csrc/*.cu`` into one library
  (numeric/kernels.py), keyed by its source hash;
* ``native.build`` — the ``g++`` build of the host library
  (native/__init__.py), keyed the same way;
* a CUDA graph's capture plus its instantiation (numeric/fused.Graph):
  the fused wave (``make_factor_fn``), the level waves
  (``stream._level_fn``), mega's buckets (``mega._bucket``), the grid's
  segments (``mesh_graphs.segment``) and the solve sweeps
  (``solve.device``), each under the JAX package's label where one
  exists.

``persistent_hit`` says whether a build was served from disk: for the two
library builds, that the hashed build directory already held the
library; for a capture it is None — a CUDA graph lives only in its
process.  So ``fresh_seconds`` is what this process really built.

Measurement: a library build is timed around its compile (or its hit); a
capture around ``capture_begin`` .. ``capture_end`` plus ``instantiate``
(``Graph.capture_s + Graph.instantiate_s``), which a replay never pays
again.

The registry is always on: builds are rare (a handful of libraries, one
capture per graph), so there is no hot-path cost to gate.  Each record
emits a ``compile`` trace span when tracing is on.  Consumers: the
``stats.compile`` block of the report (utils/stats.py, filled by
drivers/gssvx.factorize_numeric), the ``slu_compile_builds_total`` /
``slu_compile_seconds_total`` counters, refactor's ``fresh_compile_s``,
the flight recorder's ``compile`` key (obs/flightrec.py) and the program
audits' notes (utils/programaudit.py).  ``announce`` / ``pending`` name
the keys an executor expects to build and has not yet (mega's buckets).
"""

from __future__ import annotations

from dataclasses import dataclass

from superlu_dist_tpu_torch.utils.lockwatch import make_lock


@dataclass
class CompileRecord:
    """One build: where, what key, how long, and whether a disk cache
    served it."""

    site: str                 # build site, e.g. "make_factor_fn"
    key: str                  # bucket key, e.g. "lu b16 m32 w16 u16"
    seconds: float            # wall time of the build
    t0: float = 0.0           # time.perf_counter() at build start
    n_args: int = 0           # the program's parameter count
    builds: int = 1           # programs built inside this record
    persistent_hit: bool | None = None   # disk-cache hit (None: no cache)


class CompileStats:
    """Process-wide build census (module singleton ``COMPILE_STATS``).

    ``marker()`` + ``block(since=...)`` account a window (one
    factorize_numeric call) without resetting global state.
    """

    def __init__(self):
        self._lock = make_lock("CompileStats._lock")
        self.records: list[CompileRecord] = []
        # keys announced and not yet built (``pending``), and every key
        # this process built (not announced again)
        self._announced: set = set()
        self._built: set = set()
        # the program audits' notes (utils/programaudit.py), per
        # (site, label): empty when no audit ran
        self._audits: dict = {}
        self._peaks: dict = {}     # census (site, key) -> peak_bytes_est

    # ---- recording -----------------------------------------------------
    def record(self, site: str, key: str, t0: float, seconds: float,
               n_args: int = 0, builds: int = 1,
               persistent_hit: bool | None = None) -> CompileRecord:
        """Account one build and emit a ``compile`` trace span (when
        tracing is on).  ``t0`` is the ``time.perf_counter()`` at build
        start.  ``persistent_hit``: the library builds say whether their
        build directory held the library; None for a capture."""
        hit = persistent_hit
        with self._lock:
            rec = CompileRecord(site=site, key=key, seconds=float(seconds),
                                t0=float(t0), n_args=int(n_args),
                                builds=int(builds), persistent_hit=hit)
            self.records.append(rec)
            self._built.add((site, key))
            self._announced.discard((site, key))
        from superlu_dist_tpu_torch.obs.trace import get_tracer
        tr = get_tracer()
        if tr.enabled:
            tr.complete(f"compile {site}", "compile", t0, seconds,
                        key=key, n_args=int(n_args), builds=int(builds),
                        persistent_hit=hit)
        return rec

    # ---- pending-key accounting ----------------------------------------
    def announce(self, site: str, keys) -> None:
        """An executor declares the keys it expects to build, before any
        of them is built.  Keys this process already built are not
        announced again: a warmed executor leaves nothing pending."""
        with self._lock:
            for key in keys:
                if (site, key) not in self._built:
                    self._announced.add((site, str(key)))

    def pending(self) -> list[dict]:
        """Announced keys not yet built, sorted."""
        with self._lock:
            return [{"site": s, "key": k}
                    for s, k in sorted(self._announced)]

    # ---- the program audits' notes -------------------------------------
    def audit_note(self, site: str, key: str, stats: dict,
                   build: tuple | None = None) -> None:
        """The program audits report one audited program's stats, keyed
        by the program's own (site, label).  ``build``: the census
        (site, key) of the graph the program is captured into, whose
        census row then carries the note's ``peak_bytes_est`` (the
        largest of the programs captured under that key)."""
        with self._lock:
            self._audits[(site, key)] = dict(stats)
            peak = stats.get("peak_bytes_est")
            if build is not None and peak is not None:
                self._peaks[build] = max(self._peaks.get(build, 0), peak)

    def audit_block(self) -> dict:
        """The notes summed, as the JAX package sums them: program count,
        findings, donated and dead bytes (the port's in-place bytes are
        its donated bytes), coverage, baked bytes, and the sharding
        audits' count, worst peak estimate and replicated bytes."""
        with self._lock:
            audits = [dict(v) for v in self._audits.values()]
            sharding = [dict(v) for (s, k), v in self._audits.items()
                        if k.endswith("#sharding")]
        donated = sum(a.get("donated_bytes", a.get("inplace_bytes", 0))
                      for a in audits)
        dead = sum(a.get("dead_bytes", 0) for a in audits)
        return {
            "programs": len(audits),
            "findings": sum(a.get("findings", 0) for a in audits),
            "donated_bytes": int(donated),
            "dead_bytes": int(dead),
            "donation_coverage_pct": (
                100.0 if dead == 0
                else round(100.0 * donated / dead, 2)),
            "baked_const_bytes": sum(a.get("baked_const_bytes", 0)
                                     for a in audits),
            "programs_sharding_audited": len(sharding),
            "peak_bytes_est": max(
                (a.get("peak_bytes_est", 0) for a in sharding),
                default=0),
            "replicated_bytes": sum(a.get("replicated_bytes", 0)
                                    for a in sharding),
        }

    # ---- querying ------------------------------------------------------
    # readers snapshot under the lock: a serving thread may record a
    # capture while a flight-recorder dump reads the census
    def _snap(self, since: int = 0) -> list:
        with self._lock:
            return list(self.records[since:])

    def marker(self) -> int:
        """Opaque position marker for windowed accounting."""
        with self._lock:
            return len(self.records)

    def total_seconds(self, since: int = 0) -> float:
        return float(sum(r.seconds for r in self._snap(since)))

    def census(self, since: int = 0) -> list[dict]:
        """Per-(site, key) aggregation of the records after ``since``,
        by total seconds, largest first.  Rows carry ``peak_bytes_est``
        where the sharding audit noted the matching program
        (``key#sharding``) or a program captured under the row's key."""
        agg: dict[tuple, dict] = {}
        for r in self._snap(since):
            row = agg.get((r.site, r.key))
            if row is None:
                row = agg[(r.site, r.key)] = {
                    "site": r.site, "key": r.key, "n": 0, "builds": 0,
                    "seconds": 0.0, "persistent_hits": 0, "n_args": r.n_args}
            row["n"] += 1
            row["builds"] += r.builds
            row["seconds"] += r.seconds
            row["persistent_hits"] += 1 if r.persistent_hit else 0
        with self._lock:
            peaks = {(s, k[:-len("#sharding")]): v.get("peak_bytes_est")
                     for (s, k), v in self._audits.items()
                     if k.endswith("#sharding")}
            peaks.update(self._peaks)
        out = sorted(agg.values(), key=lambda row: -row["seconds"])
        for row in out:
            row["seconds"] = round(row["seconds"], 4)
            peak = peaks.get((row["site"], row["key"]))
            if peak is not None:
                row["peak_bytes_est"] = int(peak)
        return out

    def block(self, since: int = 0, top: int = 8) -> dict:
        """The ``stats.compile`` block: totals plus the top keys.
        ``fresh_seconds`` counts only the builds no disk cache served —
        what this process really built."""
        recs = self._snap(since)
        audit = self.audit_block()
        return {
            "program_audit": audit if audit["programs"] else None,
            "builds": sum(r.builds for r in recs),
            "seconds": round(sum(r.seconds for r in recs), 4),
            "fresh_seconds": round(sum(r.seconds for r in recs
                                       if not r.persistent_hit), 4),
            "persistent_hits": sum(1 for r in recs if r.persistent_hit),
            "cache_dir": None,      # the JAX block's persistent cache
            "census": self.census(since)[:top],
        }

    def _reset(self) -> None:
        """Test hygiene: drop the records, the announcements and the
        notes (the built-key set survives)."""
        with self._lock:
            self.records = []
            self._announced = set()
            self._audits = {}
            self._peaks = {}


COMPILE_STATS = CompileStats()


def record_build(site: str, key: str, t0: float, seconds: float,
                 **kw) -> CompileRecord:
    """Module-level convenience for the build sites."""
    return COMPILE_STATS.record(site, key, t0, seconds, **kw)
