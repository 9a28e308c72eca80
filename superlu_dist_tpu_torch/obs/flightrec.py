"""Flight recorder — an always-on-able bounded ring of recent telemetry.

The file tracer (obs/trace.py) is opt-in and writes continuously; a
production run that DIES needs something cheaper that is simply *there*
when the postmortem starts.  This is that device: a fixed-size
``collections.deque`` of span tuples — no I/O, no formatting, bounded
memory — that dumps ONE JSON artifact (the last N events, the active
phase stack per thread, a wall-clock anchor for cross-process
alignment, the last checkpoint flushed, the build census, and the
metrics snapshot when enabled) on:

* the construction of a structured error that carries evidence
  (``NumericBreakdownError``, ``ServePoisonedError``,
  ``ReplicaFailureError``, ... — hooked in ``utils/errors.py``);
* the chaos harness's ``HangWatchdog`` firing (testing/chaos.py);
* ``SIGTERM`` (armed by the env path / ``install(..., arm_signals=True)``);
* any explicit ``dump(reason)`` call.

Port of the JAX package's ``obs/flightrec.py``.  The dump also carries
the build census (``compile``, obs/compilestats.py — kernel builds and
graph captures, the top 16 keys).

Integration: the recorder implements the tracer protocol (``span`` /
``complete`` / ``flush`` / ``close``), so ``obs.trace.get_tracer``
composes it with the file tracer (or runs it alone) and EVERY existing
instrumentation site — phase timers, dispatch spans, the device solve's
spans, the serving tier's request spans — feeds the ring with zero new
hot-path code.

Disabled path: with ``SLU_TPU_FLIGHTREC`` unset, ``get_flightrec()``
returns the ``NULL_FLIGHTREC`` singleton — no deque, no clock, no
signal handler.

``SLU_TPU_FLIGHTREC`` values: a path-looking value names the dump
artifact (``%p`` expands to the pid — REQUIRED for multi-process runs
so processes don't clobber each other); any other truthy value enables the
recorder with the default ``flightrec-%p.json`` in the working
directory.  ``SLU_TPU_FLIGHTREC_DEPTH`` sizes the ring (default 512).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

# safe one-way dependency: trace.py imports this module only lazily
# (inside get_tracer), never at module load
from superlu_dist_tpu_torch.obs.trace import NULL_SPAN
from superlu_dist_tpu_torch.utils.lockwatch import make_lock


class NullFlightRecorder:
    """Disabled recorder: every operation is a constant-time no-op."""

    __slots__ = ()
    enabled = False
    profiling = False
    path = None          # tracer-protocol attr: no trace artifact
    dump_path = None

    def span(self, name, cat="phase", **attrs):
        return NULL_SPAN

    def complete(self, name, cat, t0, dur, **attrs):
        pass

    def event(self, name, cat="event", **attrs):
        pass

    def dump(self, reason, detail="", extra=None):
        return None

    def flush(self):
        pass

    def close(self):
        pass


NULL_FLIGHTREC = NullFlightRecorder()


class _FlightSpan:
    """One open span recorded into the ring on exit (and onto the
    per-thread phase stack while open)."""

    __slots__ = ("_fr", "name", "cat", "args", "_t0")

    def __init__(self, fr, name, cat, args):
        self._fr = fr
        self.name = name
        self.cat = cat
        self.args = args or None

    def set(self, **attrs):
        self.args = dict(self.args or ())
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._fr._push(self.name, self.cat)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._fr._pop()
        self._fr._append(self._t0, t1 - self._t0, self.name, self.cat,
                         self.args)
        return False


class FlightRecorder:
    """Enabled recorder: a bounded deque of (ts_us, dur_us, name, cat,
    args) tuples plus per-thread open-span stacks."""

    enabled = True
    profiling = False      # never force per-kernel blocking (see module doc)
    path = None            # tracer-protocol attr: no trace artifact

    def __init__(self, dump_path: str | None = None, depth: int | None = None):
        from superlu_dist_tpu_torch.utils.options import env_int
        if depth is None:
            depth = env_int("SLU_TPU_FLIGHTREC_DEPTH")
        depth = max(int(depth), 16)
        if not dump_path:
            dump_path = "flightrec-%p.json"
        self.dump_path = dump_path.replace("%p", str(os.getpid()))
        self.depth = depth
        self._ring = collections.deque(maxlen=depth)
        self._total = 0
        self._lock = make_lock("FlightRecorder._lock")
        self._stacks: dict[int, list] = {}
        # wall-clock anchor: monotonic span timestamps become absolute
        # times via unix ≈ anchor_unix + (ts_ns − anchor_perf_ns)/1e9 —
        # the cross-rank alignment key (each rank dumps its own pair)
        self._wall0 = time.time()
        self._epoch_ns = time.perf_counter_ns()
        self.dumps = 0

    # ---- ring internals -------------------------------------------------
    def _append(self, t0_ns, dur_ns, name, cat, args):
        rec = (round((t0_ns - self._epoch_ns) / 1e3, 3),
               round(dur_ns / 1e3, 3), name, cat, args)
        with self._lock:
            self._ring.append(rec)
            self._total += 1

    def _push(self, name, cat):
        ident = threading.get_ident()
        stack = self._stacks.get(ident)
        if stack is None:
            stack = self._stacks[ident] = []
        stack.append((name, cat))

    def _pop(self):
        stack = self._stacks.get(threading.get_ident())
        if stack:
            stack.pop()

    # ---- tracer protocol ------------------------------------------------
    def span(self, name, cat="phase", **attrs):
        return _FlightSpan(self, name, cat, attrs)

    def complete(self, name, cat, t0, dur, **attrs):
        """t0: time.perf_counter() seconds; dur: seconds (the
        obs.trace.Tracer.complete convention)."""
        self._append(int(t0 * 1e9), int(dur * 1e9), name, cat,
                     attrs or None)

    def event(self, name, cat="event", **attrs):
        """Point-in-time record (zero duration, stamped now)."""
        self._append(time.perf_counter_ns(), 0, name, cat, attrs or None)

    def flush(self):
        pass

    def close(self):
        pass

    # ---- the postmortem -------------------------------------------------
    def dump(self, reason: str, detail: str = "", extra: dict | None = None):
        """Write the postmortem artifact (atomic: temp + rename) and
        return its path.  Never raises — a failing dump must not mask
        the error being dumped for."""
        try:
            with self._lock:
                events = [{"ts": r[0], "dur": r[1], "name": r[2],
                           "cat": r[3],
                           **({"args": r[4]} if r[4] else {})}
                          for r in self._ring]
                stacks = {str(tid): list(stack)
                          for tid, stack in self._stacks.items() if stack}
                total = self._total
            doc = {
                "reason": str(reason),
                "detail": str(detail)[:2000],
                "pid": os.getpid(),
                "seq": self.dumps,
                "anchor": {"unix_time": self._wall0,
                           "perf_ns": self._epoch_ns},
                "dumped_unix": time.time(),
                "depth": self.depth,
                "total_events": total,
                "dropped_events": max(total - len(events), 0),
                "phase_stack": stacks,
                "events": events,
            }
            try:
                from superlu_dist_tpu_torch.obs.compilestats import (
                    COMPILE_STATS)
                doc["compile"] = COMPILE_STATS.block(top=16)
            except Exception:
                pass
            try:
                from superlu_dist_tpu_torch.obs.metrics import get_metrics
                m = get_metrics()
                if m.enabled:
                    doc["metrics"] = m.snapshot()
            except Exception:
                pass
            try:
                # crash-consistency cross-reference: the checkpoint this
                # process flushed most recently (persist/checkpoint.py) —
                # a postmortem reader goes straight from the dump to the
                # resumable frontier
                from superlu_dist_tpu_torch.persist.checkpoint import (
                    last_checkpoint)
                ck = last_checkpoint()
                if ck:
                    doc["checkpoint"] = ck
            except Exception:
                pass
            if extra:
                doc["extra"] = extra
            parent = os.path.dirname(os.path.abspath(self.dump_path))
            os.makedirs(parent, exist_ok=True)
            tmp = self.dump_path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, self.dump_path)
            self.dumps += 1
            return self.dump_path
        except Exception:
            return None


# ---- process-global recorder ------------------------------------------------

_flightrec = None
_init_lock = make_lock("obs.flightrec._init_lock")
_FLAG_FALSE = ("", "0", "false", "no", "off")


def _looks_like_path(value: str) -> bool:
    return (os.sep in value or "/" in value or value.endswith(".json"))


def _arm_sigterm(fr: FlightRecorder) -> None:
    """On SIGTERM: flush any active factor checkpoint FIRST (so the dump
    below can reference the frontier it left behind), dump the ring,
    then defer to the previous disposition — a previously-installed
    Python handler is CHAINED (it still runs), SIG_IGN is respected
    (the process chose to ignore SIGTERM; hijacking that into a kill
    would change semantics), and only the default disposition re-raises
    the fatal signal.  Only possible from the main thread; silently
    skipped elsewhere."""
    try:
        import signal
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            try:
                from superlu_dist_tpu_torch.persist.checkpoint import flush_active
                flush_active("SIGTERM")
            except Exception:
                pass
            fr.dump("SIGTERM")
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                return
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, handler)
    except (ValueError, OSError, RuntimeError):
        pass


def get_flightrec():
    """The process recorder: a ``FlightRecorder`` when
    ``SLU_TPU_FLIGHTREC`` is truthy, else ``NULL_FLIGHTREC``.  Read
    once, on first use."""
    global _flightrec
    fr = _flightrec
    if fr is None:
        with _init_lock:
            if _flightrec is None:
                from superlu_dist_tpu_torch.utils.options import env_str
                raw = env_str("SLU_TPU_FLIGHTREC").strip()
                if raw.lower() in _FLAG_FALSE:
                    _flightrec = NULL_FLIGHTREC
                else:
                    _flightrec = FlightRecorder(
                        raw if _looks_like_path(raw) else None)
                    # the dump the call graph reaches runs in the
                    # DEFERRED signal handler, not under this lock
                    _arm_sigterm(_flightrec)  # slulint: disable=SLU109
            fr = _flightrec
    return fr


def install(fr, arm_signals: bool = False):
    """Install ``fr`` as the process recorder; returns the previous one.
    Call BEFORE the first ``obs.trace.get_tracer()`` use (or follow with
    ``trace._reset()``) so the tracer composition picks it up."""
    global _flightrec
    prev = _flightrec
    _flightrec = fr
    if arm_signals and fr is not None and fr.enabled:
        _arm_sigterm(fr)
    return prev


def _reset():
    """Re-read ``SLU_TPU_FLIGHTREC`` on next use (test hygiene)."""
    global _flightrec
    _flightrec = None


def on_error(exc) -> str | None:
    """Structured-error hook (called from utils/errors.py constructors):
    dump the postmortem when the recorder is live.  A ticket-scoped
    error carrying ``ticket_stages`` (the TicketContext per-stage
    timings, obs/slo.py) gets them attached under ``extra`` — the dump
    names the stage that ate the budget.  Never raises."""
    try:
        fr = get_flightrec()
        if not fr.enabled:
            return None
        extra = None
        stages = getattr(exc, "ticket_stages", None)
        if stages:
            extra = {"ticket_stages": dict(stages)}
            trace_id = getattr(exc, "trace_id", None)
            if trace_id:
                extra["trace_id"] = trace_id
        return fr.dump(type(exc).__name__, detail=str(exc), extra=extra)
    except Exception:
        return None
