"""Request-scoped tracing + the serving SLO layer.

Port of the JAX package's ``obs/slo.py`` (pure host code, unchanged).

Two instruments live here, one per question the serving fleet must
answer:

* **"Where did this ticket's 40 ms go?"** — ``TicketContext``: a tiny
  per-request record (trace id + origin timestamp + recorded stages)
  minted at ``FleetRouter.submit`` / ``SolveServer.submit`` and carried
  with the ticket through re-routes, retries, batch coalescing, poison
  bisection, and the per-ticket BERR-refine rung.  When the ticket
  delivers, ``emit()`` writes one enclosing ``request``-category span
  plus one child span per stage (``queue_wait`` / ``coalesce`` /
  ``dispatch`` / ``device`` / ``refine`` / ``deliver`` at the server;
  ``route`` / ``reroute`` / ``serve`` at the router) into the process
  tracer — one Perfetto track per ticket, stages summing to the
  end-to-end latency by construction (each stage's end is the next
  stage's start).  Cross-process propagation is by trace id only
  (a ``parent_ref`` shim), joined offline on the tracers' clock
  anchors.

* **"Is the fleet meeting its latency SLO?"** — ``LatencyAccounter``:
  an ALWAYS-ON streaming latency histogram per (traffic class, nrhs
  bucket) with fixed log-spaced ms buckets, so p50/p95/p99 are
  available at any moment without storing samples.  Fixed buckets make
  snapshots mergeable by elementwise addition (associative +
  commutative), so replica histograms combine into exact fleet-wide quantile
  estimates.  ``SLOEvaluator`` turns the accounter into a health
  signal: per-class p99 targets (``SLU_TPU_SLO_P99_MS`` /
  ``SLU_TPU_SLO_TARGETS``) with burn-rate accounting over the
  evaluation window (fraction of requests over target, divided by the
  error budget ``SLU_TPU_SLO_BUDGET`` — burn > 1 means the budget is
  being spent faster than provisioned).

Disabled path (the NULL_TRACER discipline): when tracing is off the
serve path carries the module-level ``NULL_TICKET`` singleton — no
object is allocated per submit, no timestamp beyond the ones the
server already takes, no string is formatted.  The *accounter* is intentionally always-on: one histogram
increment per delivered ticket (a dict lookup + integer adds), the
price of never being blind to latency.
"""

from __future__ import annotations

import itertools
import os

from superlu_dist_tpu_torch.utils.lockwatch import make_lock

#: Latency histogram bucket upper bounds in MILLISECONDS — a log-ish
#: ladder from 10 us to 10 s (the implicit +Inf bucket is always last).
#: FIXED layout: every accounter everywhere uses exactly these buckets,
#: which is what makes snapshots mergeable by elementwise addition.
LAT_BUCKETS_MS = (
    0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0, 10000.0)

#: nrhs bucket lower bounds (a request with ``nrhs=k`` lands in the
#: largest bucket ≤ k) — powers of 8, the JAX package's labels.
NRHS_BUCKETS = (1, 8, 64, 512, 1024)


def nrhs_bucket(k: int) -> int:
    """The nrhs bucket label for a k-column request."""
    b = NRHS_BUCKETS[0]
    for lb in NRHS_BUCKETS:
        if k >= lb:
            b = lb
    return b


# ---- ticket context ---------------------------------------------------------

class NullTicketContext:
    """The reused no-op context: carrying/recording/emitting touches
    nothing.  ``enabled`` is False so hot paths skip even the stage
    timestamp reads."""

    __slots__ = ()
    enabled = False
    trace_id = ""

    def stage(self, name, t0, dur):
        return self

    def note(self, **attrs):
        return self

    def stages_ms(self):
        return {}

    def emit(self, tracer, t_end, name="request", **extra):
        pass


NULL_TICKET = NullTicketContext()

_seq = itertools.count()


class TicketContext:
    """One ticket's journey: trace id, origin timestamp, and the stage
    intervals recorded along the way.

    Stages are ``(name, t0, dur)`` with ``t0`` a ``time.perf_counter()``
    value (seconds) — the tracer's ``complete()`` contract.  The
    recording discipline is *contiguous coverage*: each stage starts
    where the previous one ended, so stage durations sum exactly to the
    end-to-end latency by construction.
    """

    __slots__ = ("trace_id", "ticket", "origin", "stages", "attrs")
    enabled = True

    def __init__(self, ticket, origin, parent=None):
        if parent is not None and getattr(parent, "trace_id", ""):
            self.trace_id = parent.trace_id
        else:
            self.trace_id = f"t{os.getpid():x}-{next(_seq):x}"
        self.ticket = ticket
        self.origin = float(origin)
        self.stages = []
        self.attrs = {}

    def stage(self, name, t0, dur):
        """Record one stage interval (idempotent append — re-routes may
        record ``reroute`` several times; ``stages_ms`` sums them)."""
        if dur > 0.0:
            self.stages.append((name, t0, dur))
        return self

    def note(self, **attrs):
        """Attach attributes discovered mid-flight (nrhs, replica id,
        berr...) — they land on the enclosing span's args."""
        self.attrs.update(attrs)
        return self

    def stages_ms(self) -> dict:
        """Per-stage total milliseconds (repeated stages summed), in
        first-occurrence order — the postmortem attachment format."""
        out = {}
        for name, _t0, dur in self.stages:
            out[name] = out.get(name, 0.0) + dur * 1e3
        return {k: round(v, 3) for k, v in out.items()}

    def emit(self, tracer, t_end, name="request", **extra):
        """Write the span chain: one child span per recorded stage plus
        the enclosing ``request`` span covering origin → ``t_end``.
        Stage spans carry the trace id so Perfetto queries (and
        trace_merge) can pull one ticket's track out of a fleet's."""
        tid = self.trace_id
        for sname, t0, dur in self.stages:
            tracer.complete(sname, "request", t0, dur, trace_id=tid)
        args = dict(self.attrs)
        args.update(extra)
        args["trace_id"] = tid
        args["ticket"] = self.ticket
        args["stages_ms"] = self.stages_ms()
        tracer.complete(name, "request", self.origin,
                        max(t_end - self.origin, 0.0), **args)


class _ParentRef:
    """A cross-process parent handle: carries ONLY the trace id (the
    one thing that must survive a pickle boundary), so a process
    replica's server-side context joins the router-side one."""

    __slots__ = ("trace_id",)
    enabled = True

    def __init__(self, trace_id):
        self.trace_id = str(trace_id)


def parent_ref(trace_id):
    """Wrap a wire-carried trace id as a ``parent=`` argument for
    ``SolveServer.submit`` (None/empty → no parent)."""
    return _ParentRef(trace_id) if trace_id else None


# ---- latency accounter ------------------------------------------------------

class LatencyAccounter:
    """Always-on streaming latency quantiles per (class, nrhs bucket).

    Internally one fixed-layout histogram per (klass, nrhs_bucket) key:
    ``[count, sum_ms, per-bucket counts]`` over ``LAT_BUCKETS_MS`` +
    +Inf.  Quantiles interpolate within the winning bucket (log-spaced
    buckets keep the relative error small).  ``merge_snapshot`` is
    elementwise addition, hence associative and commutative — the
    property tests/test_ticket_trace.py asserts.
    """

    def __init__(self):
        self._lock = make_lock("LatencyAccounter._lock")
        self._hists: dict[tuple, list] = {}

    # ---- producer ------------------------------------------------------
    def observe(self, nrhs, seconds, klass="serve"):
        """Record one request latency (``seconds``, converted to ms)."""
        ms = float(seconds) * 1e3
        key = (str(klass), nrhs_bucket(int(nrhs)))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [
                    0, 0.0, [0] * (len(LAT_BUCKETS_MS) + 1)]
            h[0] += 1
            h[1] += ms
            for i, ub in enumerate(LAT_BUCKETS_MS):
                if ms <= ub:
                    h[2][i] += 1
                    break
            else:
                h[2][-1] += 1

    # ---- quantiles -----------------------------------------------------
    @staticmethod
    def _quantile_from(h, q):
        count = h[0]
        if count == 0:
            return None
        rank = q * count
        acc = 0.0
        lo = 0.0
        for i, b in enumerate(h[2]):
            if b == 0:
                continue
            hi = (LAT_BUCKETS_MS[i] if i < len(LAT_BUCKETS_MS)
                  else LAT_BUCKETS_MS[-1])
            if acc + b >= rank:
                # interpolate within the bucket
                frac = 0.0 if b == 0 else max(rank - acc, 0.0) / b
                return round(lo + (hi - lo) * min(frac, 1.0), 4)
            acc += b
            lo = hi
        return round(LAT_BUCKETS_MS[-1], 4)

    def quantile(self, q, klass="serve", nrhs=1):
        """Interpolated q-quantile in ms for one (class, bucket) series
        (None when the series has no samples)."""
        key = (str(klass), nrhs_bucket(int(nrhs)))
        with self._lock:
            h = self._hists.get(key)
            h = None if h is None else [h[0], h[1], list(h[2])]
        return None if h is None else self._quantile_from(h, q)

    # ---- snapshots / merge --------------------------------------------
    def snapshot(self) -> dict:
        """``{"class|nrhs": {"count", "sum_ms", "buckets"}}`` — the
        mergeable wire format (fixed bucket layout)."""
        with self._lock:
            return {
                f"{k[0]}|{k[1]}": {"count": h[0],
                                   "sum_ms": round(h[1], 6),
                                   "buckets": list(h[2])}
                for k, h in self._hists.items()}

    def merge_snapshot(self, snap: dict):
        """Fold another accounter's ``snapshot()`` in — elementwise
        addition over the fixed bucket layout (associative, so replica →
        router → export merges in any order/grouping agree)."""
        if not snap:
            return
        with self._lock:
            for skey, sh in snap.items():
                klass, _, nb = skey.partition("|")
                key = (klass, int(nb))
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = [
                        0, 0.0, [0] * (len(LAT_BUCKETS_MS) + 1)]
                h[0] += int(sh["count"])
                h[1] += float(sh["sum_ms"])
                buckets = sh["buckets"]
                for i in range(min(len(buckets), len(h[2]))):
                    h[2][i] += int(buckets[i])

    def series(self) -> list:
        """The (klass, nrhs_bucket) keys with samples."""
        with self._lock:
            return sorted(self._hists)

    def summary(self) -> dict:
        """Per-series {count, mean_ms, p50_ms, p95_ms, p99_ms}."""
        with self._lock:
            hists = {k: [h[0], h[1], list(h[2])]
                     for k, h in self._hists.items()}
        out = {}
        for (klass, nb), h in sorted(hists.items()):
            out[f"{klass}|{nb}"] = {
                "count": h[0],
                "mean_ms": round(h[1] / h[0], 4) if h[0] else None,
                "p50_ms": self._quantile_from(h, 0.50),
                "p95_ms": self._quantile_from(h, 0.95),
                "p99_ms": self._quantile_from(h, 0.99),
            }
        return out

    def report_lines(self) -> list:
        """Human lines for Stats.report() — empty when no samples."""
        lines = []
        for key, s in self.summary().items():
            if not s["count"]:
                continue
            klass, _, nb = key.partition("|")
            lines.append(
                f"  {klass:<8s} nrhs>={nb:<5s} n={s['count']:<7d} "
                f"mean {s['mean_ms']:8.3f} ms   p50 {s['p50_ms']:8.3f}"
                f"   p95 {s['p95_ms']:8.3f}   p99 {s['p99_ms']:8.3f}")
        return lines

    def publish(self, metrics):
        """Push per-series quantile gauges into a metrics registry
        (``slu_latency_p{50,95,99}_ms{class,nrhs}``) — the slu_top /
        Prometheus surface."""
        if metrics is None or not metrics.enabled:
            return
        for key, s in self.summary().items():
            klass, _, nb = key.partition("|")
            labels = {"class": klass, "nrhs": nb}
            metrics.set("slu_latency_requests_total", s["count"], **labels)
            for q in ("p50", "p95", "p99"):
                v = s[f"{q}_ms"]
                if v is not None:
                    metrics.set(f"slu_latency_{q}_ms", v, **labels)

    # ---- cross-rank aggregation ---------------------------------------
    def reduce(self, comm):
        """Collective fleet/rank-wide merge (the Stats.reduce fixed-
        layout discipline): every rank contributes its snapshot via
        bcast_obj, rank 0's accounter absorbs all of them, and the
        merged summary is broadcast back.  COLLECTIVE — every rank must
        call at the same point."""
        for r in range(comm.n_ranks):
            snap = comm.bcast_obj(
                self.snapshot() if comm.rank == r else None, root=r)
            if comm.rank == 0 and r != 0:
                self.merge_snapshot(snap)
        return comm.bcast_obj(
            self.summary() if comm.rank == 0 else None, root=0)


# ---- SLO evaluator ----------------------------------------------------------

class SLOEvaluator:
    """Burn-rate SLO evaluation over a LatencyAccounter.

    Targets come from two knobs: ``SLU_TPU_SLO_P99_MS`` (one global p99
    target in ms; 0 = no SLO) and ``SLU_TPU_SLO_TARGETS`` (per-class
    overrides, ``"class=ms,class=ms"``).  ``SLU_TPU_SLO_BUDGET`` is the
    error budget: the provisioned fraction of requests allowed over
    target (default 1%).  ``evaluate()`` is windowed on the DELTA since
    the previous call, so a long-healthy fleet's burn rate reflects
    current traffic, not its whole history.
    """

    def __init__(self, p99_ms=None, targets=None, budget=None):
        from superlu_dist_tpu_torch.utils.options import env_float, env_str
        if p99_ms is None:
            p99_ms = env_float("SLU_TPU_SLO_P99_MS")
        self.p99_ms = float(p99_ms)
        self.budget = float(env_float("SLU_TPU_SLO_BUDGET")
                            if budget is None else budget)
        self.targets = dict(targets or {})
        if not targets:
            raw = env_str("SLU_TPU_SLO_TARGETS").strip()
            for part in raw.split(","):
                if "=" in part:
                    klass, _, ms = part.partition("=")
                    try:
                        self.targets[klass.strip()] = float(ms)
                    except ValueError:
                        pass
        self._prev: dict = {}

    @property
    def armed(self) -> bool:
        return self.p99_ms > 0.0 or bool(self.targets)

    def target_for(self, klass) -> float:
        return float(self.targets.get(klass, self.p99_ms))

    def evaluate(self, accounter) -> dict:
        """Per-series SLO state over the window since the last call:
        ``{"class|nrhs": {count, p99_ms, target_ms, over, burn, ok}}``.
        ``burn`` = (fraction of windowed requests over target) /
        budget; burn ≤ 1 means within budget (``ok``)."""
        snap = accounter.snapshot()
        out = {}
        for key, h in snap.items():
            klass, _, _nb = key.partition("|")
            target = self.target_for(klass)
            if target <= 0.0:
                continue
            prev = self._prev.get(key)
            if prev is None:
                dcount = h["count"]
                dbuckets = list(h["buckets"])
            else:
                dcount = h["count"] - prev["count"]
                dbuckets = [b - p for b, p in
                            zip(h["buckets"], prev["buckets"])]
            if dcount <= 0:
                continue
            over = 0
            for i, b in enumerate(dbuckets):
                lo = LAT_BUCKETS_MS[i - 1] if i > 0 else 0.0
                if lo >= target:
                    over += b
            frac_over = over / dcount
            burn = frac_over / self.budget if self.budget > 0 else (
                float("inf") if over else 0.0)
            win = [dcount, 0.0, dbuckets]
            out[key] = {
                "count": dcount,
                "p99_ms": LatencyAccounter._quantile_from(win, 0.99),
                "target_ms": target,
                "over": over,
                "burn": round(burn, 4),
                "ok": burn <= 1.0,
            }
        self._prev = snap
        return out


# ---- process-global accounter ----------------------------------------------

_accounter = None
_init_lock = make_lock("obs.slo._init_lock")


def get_accounter() -> LatencyAccounter:
    """The process latency accounter — ALWAYS enabled (one histogram
    increment per request is the observability floor)."""
    global _accounter
    a = _accounter
    if a is None:
        with _init_lock:
            if _accounter is None:
                _accounter = LatencyAccounter()
            a = _accounter
    return a


def install(accounter):
    """Install ``accounter`` as the process accounter (test hygiene);
    returns the previous one."""
    global _accounter
    prev = _accounter
    _accounter = accounter
    return prev


def _reset():
    global _accounter
    _accounter = None
