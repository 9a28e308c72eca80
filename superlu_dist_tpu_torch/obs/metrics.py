"""Serving-grade metrics registry — labeled counters / gauges / histograms.

The tracer (obs/trace.py) answers "where did THIS run's time go"; a
serving fleet needs the orthogonal question answered continuously:
counters and distributions that accumulate across thousands of solves
and export to a scraper.  This module is that substrate: a
zero-dependency registry of labeled counters, gauges, and fixed-bucket
histograms with JSON and Prometheus-text exports, and
``Stats.reduce``-style cross-rank aggregation over a TreeComm
(``reduce(comm)``, parallel/treecomm.py).  Port of the JAX package's
``obs/metrics.py``.

Wired producers: the driver (``drivers/gssvx.py`` — factorizations,
GEMM tiers, schedule shape, the build census's builds and seconds,
ladder rung transitions, refactors), the retrace sentinel
(``numeric/stream.py``), the serving tier (``serve/server.py``,
``serve/fleet.py``, ``serve/handlecache.py``) and the lock-order
verifier (``utils/lockwatch.py`` — lock hold times).

Disabled path (the NULL_TRACER discipline): with ``SLU_TPU_METRICS``
unset, ``get_metrics()`` returns the module-level ``NULL_METRICS``
singleton whose every method is a constant-time no-op — no dict entry,
no label tuple, no lock.  Producers that sit on hot paths latch
``m if m.enabled else None`` once and pay a single ``is None`` test per
event.

``SLU_TPU_METRICS`` values: ``1`` (or any truthy non-path) enables the
registry; a path-looking value (contains a separator or ends in
``.json`` / ``.prom`` / ``.txt``) additionally dumps the export there
at process exit (``%p`` expands to the pid).  ``.json`` → JSON export,
anything else → Prometheus text.
"""

from __future__ import annotations

import atexit
import json
import os
import threading

import numpy as np

from superlu_dist_tpu_torch.utils.lockwatch import make_lock

#: Histogram bucket upper bounds (seconds-flavored log decades); the
#: implicit +Inf bucket is always last.
HIST_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)

_FLAG_FALSE = ("", "0", "false", "no", "off")


class NullMetrics:
    """Disabled registry: every operation is a constant-time no-op."""

    __slots__ = ()
    enabled = False

    def inc(self, name, value=1.0, **labels):
        pass

    def set(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def snapshot(self):
        return {}

    def merge_snapshot(self, snap, base=None):
        pass

    def dump_now(self):
        return False

    def to_json(self):
        return "{}"

    def to_prometheus(self):
        return ""

    def reduce(self, comm):
        return {}


NULL_METRICS = NullMetrics()


def _series(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


def _parse_fmt(key: str) -> tuple:
    """Invert ``_fmt``: ``name{k="v",...}`` back to the series tuple —
    the snapshot-merge path (a snapshot's keys are _fmt strings)."""
    import re
    m = re.match(r'^([^{]+)\{(.*)\}$', key)
    if m is None:
        return (key, ())
    labels = tuple(re.findall(r'([\w.]+)="([^"]*)"', m.group(2)))
    return (m.group(1), labels)


def _fmt(series: tuple) -> str:
    name, labels = series
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Metrics:
    """Enabled registry.  Thread-safe; label sets are free-form (each
    distinct (name, labels) pair is one series)."""

    enabled = True

    def __init__(self):
        self._lock = make_lock("Metrics._lock")
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        # histogram: [count, sum, min, max, per-bucket counts]
        self._hists: dict[tuple, list] = {}
        # armed by get_metrics() when SLU_TPU_METRICS names a path —
        # dump_now() refreshes the export mid-run (slu_top's feed)
        self.export_path: str | None = None

    def dump_now(self) -> bool:
        """Refresh the on-disk export immediately (atomic temp+rename,
        same artifact the atexit dump writes).  True when a path is
        armed; no-op False otherwise."""
        if not self.export_path:
            return False
        _dump(self, self.export_path)
        return True

    # ---- producers -----------------------------------------------------
    def inc(self, name, value=1.0, **labels):
        key = _series(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def set(self, name, value, **labels):
        key = _series(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name, value, **labels):
        key = _series(name, labels)
        value = float(value)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = [0, 0.0, float("inf"),
                                        float("-inf"),
                                        [0] * (len(HIST_BUCKETS) + 1)]
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)
            for i, ub in enumerate(HIST_BUCKETS):
                if value <= ub:
                    h[4][i] += 1
                    break
            else:
                h[4][-1] += 1

    # ---- exports -------------------------------------------------------
    def snapshot(self) -> dict:
        """{"counters": {...}, "gauges": {...}, "histograms": {...}} with
        human-readable ``name{label="v"}`` keys."""
        with self._lock:
            return {
                "counters": {_fmt(k): v for k, v in self._counters.items()},
                "gauges": {_fmt(k): v for k, v in self._gauges.items()},
                "histograms": {
                    _fmt(k): {"count": h[0], "sum": h[1],
                              "min": (None if h[0] == 0 else h[2]),
                              "max": (None if h[0] == 0 else h[3]),
                              "buckets": list(h[4])}
                    for k, h in self._hists.items()},
            }

    def merge_snapshot(self, snap: dict, base: dict | None = None):
        """Fold another registry's ``snapshot()`` into this one —
        the fleet-wide aggregation path (a process replica's child
        registry dies with the process; the router absorbs its
        snapshots at heartbeat/teardown so ``to_prometheus()`` covers
        the whole fleet).

        ``base`` is the previously absorbed snapshot from the SAME
        source: counters and histogram counts/sums/buckets merge as the
        DELTA vs base (so repeated heartbeat absorption never double
        counts), gauges and min/max merge absolutely (last/extreme
        writer wins)."""
        if not snap:
            return
        base = base or {}
        bc = base.get("counters", {})
        bh = base.get("histograms", {})
        with self._lock:
            for key, v in snap.get("counters", {}).items():
                d = float(v) - float(bc.get(key, 0.0))
                if d:
                    sk = _parse_fmt(key)
                    self._counters[sk] = self._counters.get(sk, 0.0) + d
            for key, v in snap.get("gauges", {}).items():
                self._gauges[_parse_fmt(key)] = float(v)
            for key, sh in snap.get("histograms", {}).items():
                prev = bh.get(key) or {"count": 0, "sum": 0.0,
                                       "buckets": [0] * (len(sh["buckets"]))}
                sk = _parse_fmt(key)
                h = self._hists.get(sk)
                if h is None:
                    h = self._hists[sk] = [0, 0.0, float("inf"),
                                           float("-inf"),
                                           [0] * (len(HIST_BUCKETS) + 1)]
                h[0] += int(sh["count"]) - int(prev["count"])
                h[1] += float(sh["sum"]) - float(prev["sum"])
                if sh.get("min") is not None:
                    h[2] = min(h[2], float(sh["min"]))
                if sh.get("max") is not None:
                    h[3] = max(h[3], float(sh["max"]))
                for i in range(min(len(sh["buckets"]), len(h[4]))):
                    h[4][i] += int(sh["buckets"][i]) - int(
                        prev["buckets"][i] if i < len(prev["buckets"])
                        else 0)

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (type comments + counter/gauge
        samples, histograms as _bucket/_sum/_count)."""
        lines = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: [h[0], h[1], list(h[4])]
                     for k, h in self._hists.items()}
        for name in sorted({k[0] for k in counters}):
            lines.append(f"# TYPE {name} counter")
            for k in sorted(k for k in counters if k[0] == name):
                lines.append(f"{_fmt(k)} {counters[k]:g}")
        for name in sorted({k[0] for k in gauges}):
            lines.append(f"# TYPE {name} gauge")
            for k in sorted(k for k in gauges if k[0] == name):
                lines.append(f"{_fmt(k)} {gauges[k]:g}")
        for name in sorted({k[0] for k in hists}):
            lines.append(f"# TYPE {name} histogram")
            for k in sorted(k for k in hists if k[0] == name):
                count, total, buckets = hists[k]
                labels = dict(k[1])
                acc = 0
                for ub, b in zip(tuple(HIST_BUCKETS) + ("+Inf",),
                                 buckets):
                    acc += b
                    lk = _series(name + "_bucket",
                                 {**labels, "le": str(ub)})
                    lines.append(f"{_fmt(lk)} {acc}")
                lines.append(
                    f"{_fmt(_series(name + '_sum', labels))} {total:g}")
                lines.append(
                    f"{_fmt(_series(name + '_count', labels))} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    # ---- cross-rank aggregation ---------------------------------------
    def _flat(self) -> dict:
        """Scalar view for the collective reduction: counters and gauges
        as-is, histograms flattened to _count/_sum."""
        with self._lock:
            out = {("counter",) + k: v for k, v in self._counters.items()}
            out.update({("gauge",) + k: v
                        for k, v in self._gauges.items()})
            for k, h in self._hists.items():
                out[("hist_count",) + k] = float(h[0])
                out[("hist_sum",) + k] = float(h[1])
        return out

    def reduce(self, comm) -> dict:
        """Cross-rank metric aggregation (the Stats.reduce discipline —
        COLLECTIVE: every rank must call at the same point, with the
        registry enabled on every rank).  Series sets may differ per
        rank: the key union is agreed via one bcast_obj per rank (every
        rank participates in every broadcast), then one matrix
        sum-allreduce carries the aligned values, from which per-series
        sum/min/max/avg over ranks are exact."""
        local = self._flat()
        keys = sorted(local)
        all_keys = set(keys)
        for r in range(comm.n_ranks):
            got = comm.bcast_obj(keys if comm.rank == r else None, root=r)
            all_keys.update(got)
        ordered = sorted(all_keys)
        vec = np.asarray([local.get(k, 0.0) for k in ordered],
                         dtype=np.float64)
        mat = np.zeros((comm.n_ranks, max(vec.size, 1)))
        mat[comm.rank, :vec.size] = vec
        mat = np.asarray(comm.allreduce_sum_any(mat)).reshape(
            comm.n_ranks, -1)
        out = {}
        for j, k in enumerate(ordered):
            col = mat[:, j]
            kind, name, labels = k
            out[f"{kind}:{_fmt((name, labels))}"] = {
                "sum": float(col.sum()), "min": float(col.min()),
                "max": float(col.max()), "avg": float(col.mean())}
        return out


# ---- process-global registry ----------------------------------------------

_metrics = None
_init_lock = make_lock("obs.metrics._init_lock")


def _looks_like_path(value: str) -> bool:
    return (os.sep in value or "/" in value
            or value.endswith((".json", ".prom", ".txt")))


def _dump(metrics: Metrics, path: str) -> None:
    path = path.replace("%p", str(os.getpid()))
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(metrics.to_json() if path.endswith(".json")
                else metrics.to_prometheus())
    os.replace(tmp, path)


def get_metrics():
    """The process registry: a ``Metrics`` when ``SLU_TPU_METRICS`` is
    truthy, else the ``NULL_METRICS`` singleton.  Read once, on first
    use (tests reconfigure via ``install``/``_reset``)."""
    global _metrics
    m = _metrics
    if m is None:
        with _init_lock:
            if _metrics is None:
                from superlu_dist_tpu_torch.utils.options import env_str
                raw = env_str("SLU_TPU_METRICS").strip()
                if raw.lower() in _FLAG_FALSE:
                    _metrics = NULL_METRICS
                else:
                    _metrics = Metrics()
                    if _looks_like_path(raw):
                        _metrics.export_path = raw
                        atexit.register(_dump, _metrics, raw)
            m = _metrics
    return m


def install(metrics):
    """Install ``metrics`` as the process registry (programmatic enable
    for tests and embedding callers); returns the previous one.
    NOTE: producers that latched the previous registry at construction
    (the serving tier) keep it — install before building them."""
    global _metrics
    prev = _metrics
    _metrics = metrics
    return prev


def _reset():
    """Re-read ``SLU_TPU_METRICS`` on next use (test hygiene)."""
    global _metrics
    _metrics = None
