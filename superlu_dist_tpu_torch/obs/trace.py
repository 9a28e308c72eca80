"""Zero-dependency structured span tracer — the PROFlevel≥1 substrate.

The reference's PROFlevel builds expose what every performance mystery
here has needed re-derived by hand: where the time went, per phase, per
kernel shape, per transfer (SRC/util.c:538-630 comm split; the
dgemm_mnk.dat GEMM-shape trace, SRC/pdgstrf.c:380-387).  This module is
the one sink all of that flows into: nested spans with categories
(phase / dispatch / kernel / comm / host-offload), monotonic
timestamps, and per-span attributes (supernode counts, m/w/u shapes,
bytes, dtypes).

Artifacts (env-gated by ``SLU_TPU_TRACE=<path>``):

* ``<path>``         — Chrome trace-event JSON (``{"traceEvents": [...]}``
  with "X" complete events, microsecond timestamps, events sorted by
  start time) — load it in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``;
* ``<path>l`` (``.json`` → ``.jsonl``, anything else gets ``.jsonl``
  appended) — the same records as line-delimited JSON, appended as each
  span CLOSES, so a crashed run still leaves every completed span on
  disk.

``%p`` in the path expands to the process id, so multi-process
callers (the fleet's process replicas, serve/fleet.py) can share one env
var without clobbering each other's artifacts.  Port of the JAX
package's ``obs/trace.py``: the same events, the same artifact formats.
Spans are host timestamps around calls that already synchronize, and
the factor executors' kernel spans are device times between CUDA events
read after the synchronization each call makes anyway
(obs/kernelspans.py) — an enabled tracer adds no device work and no
device sync.

Disabled path (env unset): ``get_tracer()`` returns the module-level
``NULL_TRACER`` singleton whose ``span()`` hands back one reused no-op
span object — no file is opened, no string is formatted, no timestamp
is read.  Hot loops additionally guard on ``tracer.enabled`` so even
the attribute-dict construction is skipped when tracing is off.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

from superlu_dist_tpu_torch.utils.lockwatch import make_lock
import time

#: Span categories (the ``cat`` field of every record), the JAX
#: package's set.  "verify" spans mark the device solve's non-finite
#: probe (solve/device.py); the "compile" category is the JAX package's
#: compile census, which the port does not have.  "request" spans come
#: from the serving tier's TicketContext (obs/slo.py, emitted by
#: serve/server.py and serve/fleet.py): one enclosing span per ticket
#: with nested per-stage children (queue_wait / coalesce / dispatch /
#: device / refine / deliver), all tagged with the ticket's trace_id so
#: a ticket can be joined across processes.
CATEGORIES = ("phase", "dispatch", "kernel", "comm", "host-offload",
              "verify", "compile", "request")


class _NullSpan:
    """The reused no-op span: entering/exiting touches nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a constant-time no-op."""

    __slots__ = ()
    enabled = False
    profiling = False
    path = None

    def span(self, name, cat="phase", **attrs):
        return NULL_SPAN

    def complete(self, name, cat, t0, dur, **attrs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()

#: this process's id, stamped on every record: read once (and again in a
#: forked child), not by a system call a record — a factor executor
#: records several spans a group, and a virtualized host can take tens of
#: microseconds a call
_PID = os.getpid()


def _refresh_pid():
    global _PID
    _PID = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


class _Span:
    """One open span; records itself on ``__exit__``."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (e.g. a result size)."""
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._tracer._enter_thread()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._record(self.name, self.cat, self._t0, t1 - self._t0,
                             self.args, depth_delta=-1)
        return False


class Tracer:
    """Collecting tracer: spans accumulate in memory (for the Chrome
    artifact) and stream to the JSONL sidecar as they close."""

    enabled = True
    profiling = True     # the factor executors' kernel spans: the JAX
                         # package blocks per kernel under it, the port
                         # times them by CUDA events (obs/kernelspans.py)
                         # and adds no device sync

    def __init__(self, path: str):
        path = path.replace("%p", str(os.getpid()))
        self.path = path
        self.jsonl_path = (path[:-5] + ".jsonl" if path.endswith(".json")
                           else path + ".jsonl")
        self._epoch_ns = time.perf_counter_ns()
        self._lock = make_lock("Tracer._lock")
        self._events = []
        self._tids = {}
        self._tls = threading.local()
        self._jsonl = None
        self._closed = False
        # wall-clock anchor: every span timestamp is monotonic, so a
        # multi-rank Perfetto merge (or a flight-recorder dump) needs one
        # absolute reference per process — unix ≈ unix_time + ts_us/1e6
        self._record("clock-anchor", "phase", self._epoch_ns, 0,
                     {"unix_time": round(time.time(), 6),
                      "perf_ns": self._epoch_ns})

    # ---- internals -----------------------------------------------------
    def _enter_thread(self):
        self._tls.depth = getattr(self._tls, "depth", 0) + 1

    def _tid(self):
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _record(self, name, cat, t0_ns, dur_ns, args, depth_delta=0):
        if depth_delta:
            self._tls.depth = getattr(self._tls, "depth", 0) + depth_delta
        ev = {
            "name": str(name), "cat": str(cat), "ph": "X",
            "ts": round((t0_ns - self._epoch_ns) / 1e3, 3),   # microseconds
            "dur": round(dur_ns / 1e3, 3),
            "pid": _PID, "tid": self._tid(),
            "depth": getattr(self._tls, "depth", 0),
        }
        if args:
            ev["args"] = args
        with self._lock:
            if self._closed:
                return
            self._events.append(ev)
            if self._jsonl is None:
                os.makedirs(os.path.dirname(os.path.abspath(
                    self.jsonl_path)), exist_ok=True)
                # the lock exists to serialize exactly these
                # crash-safe sidecar appends: the write IS the
                # guarded operation
                self._jsonl = open(
                    self.jsonl_path, "w", buffering=1)
            self._jsonl.write(json.dumps(ev, default=str) + "\n")

    # ---- public API ----------------------------------------------------
    def span(self, name, cat="phase", **attrs):
        """Context manager timing a nested span.  ``attrs`` should be
        plain scalars (ints/floats/short strings) — they land in the
        record's ``args``."""
        return _Span(self, name, cat, attrs)

    def complete(self, name, cat, t0, dur, **attrs):
        """Record an already-timed span: ``t0`` is a ``time.perf_counter()``
        value (seconds), ``dur`` its duration in seconds.  For call sites
        that must time unconditionally (profiling counters) and only
        *emit* when tracing is on."""
        self._record(name, cat, int(t0 * 1e9), int(dur * 1e9), attrs)

    def flush(self):
        """Write the Chrome trace-event artifact (atomically: temp file +
        rename, so a reader never sees a torn JSON)."""
        with self._lock:
            events = sorted(self._events,
                            key=lambda e: (e["pid"], e["ts"], -e["dur"]))
            doc = {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"tool": "superlu_dist_tpu_torch.obs",
                              "pid": os.getpid(),
                              "spans": len(events)},
            }
            tmp = self.path + f".tmp{os.getpid()}"
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            # atomic artifact write serialized by the same lock —
            # the flush is the guarded operation
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.path)

    def close(self):
        if self._closed:
            return
        self.flush()
        with self._lock:
            self._closed = True
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None


class _TeeSpan:
    """One span mirrored into every child tracer."""

    __slots__ = ("_spans",)

    def __init__(self, spans):
        self._spans = spans

    def __enter__(self):
        for s in self._spans:
            s.__enter__()
        return self

    def __exit__(self, *exc):
        for s in reversed(self._spans):
            s.__exit__(*exc)
        return False

    def set(self, **attrs):
        for s in self._spans:
            s.set(**attrs)
        return self


class TeeTracer:
    """Fan-out tracer: every span/record goes to each child (the file
    tracer + the flight recorder when both are enabled)."""

    enabled = True

    def __init__(self, *tracers):
        self._tracers = [t for t in tracers if t is not None and t.enabled]

    @property
    def path(self):
        for t in self._tracers:
            if getattr(t, "path", None):
                return t.path
        return None

    @property
    def profiling(self):
        return any(getattr(t, "profiling", False) for t in self._tracers)

    def span(self, name, cat="phase", **attrs):
        return _TeeSpan([t.span(name, cat, **attrs) for t in self._tracers])

    def complete(self, name, cat, t0, dur, **attrs):
        for t in self._tracers:
            t.complete(name, cat, t0, dur, **attrs)

    def flush(self):
        for t in self._tracers:
            t.flush()

    def close(self):
        for t in self._tracers:
            t.close()


# ---- process-global tracer -------------------------------------------------

_tracer = None
_init_lock = make_lock("obs.trace._init_lock")


def get_tracer():
    """The process tracer, composed from two env gates on first use:
    ``SLU_TPU_TRACE`` (the file tracer) and ``SLU_TPU_FLIGHTREC`` (the
    ring-buffer flight recorder, obs/flightrec.py — it implements the
    tracer protocol, so every instrumentation site feeds it for free).
    Both on → a ``TeeTracer``; one on → that one; neither → the
    ``NULL_TRACER`` singleton.  Tests reconfigure via
    ``install``/``_reset``."""
    global _tracer
    t = _tracer
    if t is None:
        with _init_lock:
            if _tracer is None:
                from superlu_dist_tpu_torch.utils.options import env_str
                path = env_str("SLU_TPU_TRACE").strip()
                file_tracer = None
                if path:
                    # init-once singleton construction: the anchor
                    # record it writes is the guarded operation
                    file_tracer = Tracer(path)
                    atexit.register(file_tracer.close)
                from superlu_dist_tpu_torch.obs.flightrec import get_flightrec
                # the open the call graph sees runs in a DEFERRED
                # SIGTERM handler, never under this init lock
                fr = get_flightrec()
                if file_tracer is not None and fr.enabled:
                    _tracer = TeeTracer(file_tracer, fr)
                elif file_tracer is not None:
                    _tracer = file_tracer
                elif fr.enabled:
                    _tracer = fr
                else:
                    _tracer = NULL_TRACER
            t = _tracer
    return t


def install(tracer):
    """Install ``tracer`` as the process tracer (programmatic enable for
    tests and embedding callers); returns the previous one.  The caller
    owns flushing/closing both."""
    global _tracer
    prev = _tracer
    _tracer = tracer
    return prev


def _reset():
    """Close any active tracer and re-read ``SLU_TPU_TRACE`` on next use
    (test hygiene)."""
    global _tracer
    t = _tracer
    _tracer = None
    if t is not None and t is not NULL_TRACER:
        t.close()


def enabled() -> bool:
    return get_tracer().enabled


def span(name, cat="phase", **attrs):
    """Module-level convenience: ``with span("FACT", cat="phase"): ...``"""
    return get_tracer().span(name, cat, **attrs)


def complete(name, cat, t0, dur, **attrs):
    get_tracer().complete(name, cat, t0, dur, **attrs)
