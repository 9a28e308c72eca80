"""Serving fleet — health-checked routing over multi-handle replicas.

Port of the JAX package's ``serve/fleet.py``, the tier ABOVE
:class:`~superlu_dist_tpu_torch.serve.server.SolveServer`: one server
owns one factored handle in one process; real traffic is many matrices
(per-user/per-model systems), rolling refactorizations, and more QPS
than one server.  This module composes:

* **multi-handle replicas** — each replica owns a
  :class:`~superlu_dist_tpu_torch.serve.handlecache.HandleCache` (LRU of
  factored handles loaded zero-refactor from sha256-manifested persist
  bundles, byte-budgeted via the ``lu_meta`` cheap peek, scrub-verified
  on every load), so ONE replica serves a mixed stream of matrices
  keyed by the caller's bundle key.  Replicas come in two isolations
  behind the same interface: in-process worker threads
  (:class:`ThreadReplica`) and spawned worker processes
  (:class:`ProcessReplica`, the kill -9 failure domain).  On one card
  every replica loads its handles onto that card: a process replica has
  its own CUDA context and captures its own solve graphs.
* **health-checked routing** — :class:`FleetRouter` fans
  ``submit(key, b)`` across N replicas (handle-affinity first, then
  least-loaded), with replica health judged by :func:`pid_alive`
  (kill(pid,0) + zombie state) for process replicas and worker-thread
  liveness for thread replicas — a SLOW replica is never declared
  failed (the slow-not-dead discipline), a quarantined one is routed
  around but never killed.
* **fleet backpressure** — ``SLU_TPU_FLEET_QUEUE_MAX`` sheds at the
  router (reason ``fleet_queue_full``) before any replica queues the
  work, and ``SLU_TPU_FLEET_DEADLINE_MS`` arms END-TO-END per-ticket
  deadlines (queued, in flight, or mid-failover — the health monitor
  and the waiting ticket both expire it).
* **zero-loss failover** — every accepted ticket carries an idempotent
  retry token; when a replica dies (pid gone, pipe closed, worker
  crashed) or quarantines, the router re-routes every ticket that
  replica had accepted but not delivered to a healthy replica under
  the SAME token (first delivery wins, duplicates are dropped), so the
  client observes bitwise-identical X and never an error while a
  healthy replica remains.  The failover dumps a flight-recorder
  postmortem (:class:`ReplicaFailureError` construction) naming the
  dead replica and the re-routed ticket set.
* **rolling deploy** — :meth:`FleetRouter.deploy` drives per-replica
  ``SolveServer.swap`` one replica at a time (the swap IS the
  drain/resume point: queued + future tickets on the new handle, the
  in-flight batch finishes on the old one — zero dropped), gating each
  replica behind the new bundle's load/scrub integrity verification
  and a canary batch (finiteness + optional componentwise-BERR gate);
  any failure rolls every already-swapped replica back to the previous
  bundle and raises :class:`DeployRollbackError`.

Determinism contract: a replica serves each accepted ticket as its OWN
micro-batch (the worker is serialized, and the fleet's default server
keywords disable the coalescing window).  Batch composition is part of
the arithmetic — the nrhs width selects the padded bucket, hence the
solve graph and its cuBLAS algorithms — so one-ticket-one-batch is what
makes a re-routed ticket's X **bitwise identical** to the undisturbed
run.  Cross-replica concurrency, not cross-request coalescing, is the
fleet's throughput axis.

Metrics (obs/metrics.py): ``slu_fleet_replicas_healthy`` gauge,
``slu_fleet_{requests,columns,reroutes,failovers,deploys,rollbacks,
handle_evictions}_total`` counters and the ``slu_fleet_route_seconds``
submit→delivery histogram.  Chaos specs ``kill_replica=R@batch=K``,
``quarantine_replica=R`` and ``slow_replica=R,secs=S``
(testing/chaos.py) drive the failure domains deterministically.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time

import numpy as np

from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.obs.slo import (NULL_TICKET, SLOEvaluator,
                                      TicketContext, get_accounter,
                                      parent_ref)
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.parallel.treecomm import pid_alive
from superlu_dist_tpu_torch.serve.handlecache import HandleCache
from superlu_dist_tpu_torch.serve.server import on_device
from superlu_dist_tpu_torch.utils.errors import (
    CheckpointError, DeployRollbackError, FactorCorruptError,
    RefactorRollbackError, ReplicaFailureError, ServeDeadlineError,
    ServeOverloadError, ServerClosedError, SuperLUError)
from superlu_dist_tpu_torch.utils.lockwatch import make_condition, make_lock

#: default SolveServer keywords for fleet-loaded handles: no coalescing
#: window — one accepted ticket, one micro-batch (the determinism
#: contract in the module docstring)
FLEET_SERVER_KW = {"max_wait_s": 0.0}


class _RemoteServeError(SuperLUError):
    """A process replica's per-ticket serve error, re-raised in the
    router process.  Structured errors do not round-trip a pickle
    faithfully (their constructors take positional evidence), so the
    child ships ``(type name, message)`` and the router wraps them —
    ``remote_type`` keeps the verdict inspectable."""

    def __init__(self, remote_type: str, message: str, replica: int):
        self.remote_type = remote_type
        self.replica = int(replica)
        super().__init__(
            f"replica {replica} served a structured error "
            f"({remote_type}): {message}")


class _TicketRec:
    """Router-side record of one accepted ticket (the idempotent retry
    token is ``token``; delivery is first-wins)."""

    __slots__ = ("token", "key", "b", "k", "squeeze", "t_submit",
                 "deadline_s", "t_deadline", "event", "error", "x",
                 "replica", "tried", "attempts", "ctx", "t_routed")

    def __init__(self, token: int, key, b: np.ndarray, squeeze: bool):
        self.token = token
        self.key = key
        self.b = b
        self.k = b.shape[1]
        self.squeeze = squeeze
        self.ctx = NULL_TICKET   # TicketContext when tracing is on
        self.t_submit = time.perf_counter()
        self.t_routed = self.t_submit   # last route/reroute stage edge
        self.deadline_s = 0.0
        self.t_deadline = None
        self.event = threading.Event()
        self.error = None
        self.x = None
        self.replica = -1
        self.tried = set()
        self.attempts = 0


class FleetTicket:
    """Future-style handle for one fleet submit.  ``result()`` returns
    the solved X (or raises the ticket's structured error); a replica
    death between submit and delivery is INVISIBLE here — the router
    re-routes under the same token and the X that arrives is bitwise
    identical to an undisturbed run."""

    def __init__(self, rec: _TicketRec, router: "FleetRouter"):
        self._rec = rec
        self._router = router

    @property
    def token(self) -> int:
        """The idempotent retry token this ticket travels under."""
        return self._rec.token

    def done(self) -> bool:
        return self._rec.event.is_set()

    @property
    def attempts(self) -> int:
        """Routing attempts so far (1 = never re-routed)."""
        return self._rec.attempts

    def result(self, timeout: float | None = None) -> np.ndarray:
        rec = self._rec
        end = None if timeout is None else time.perf_counter() + timeout
        while not rec.event.is_set():
            now = time.perf_counter()
            if end is not None and now >= end:
                raise TimeoutError(
                    f"fleet ticket {rec.token} ({rec.k} columns, key "
                    f"{rec.key!r}) not delivered within {timeout}s")
            bounds = [] if end is None else [end - now]
            if rec.t_deadline is not None:
                if now >= rec.t_deadline:
                    # end-to-end deadline: expire it ourselves when the
                    # monitor has not yet (no-op if delivery raced us)
                    self._router._expire(rec, now)
                    bounds = [0.05] + bounds
                else:
                    bounds.append(rec.t_deadline - now)
            rec.event.wait(min(bounds) if bounds else 0.5)
        if rec.error is not None:
            raise rec.error
        x = rec.x
        return x[:, 0] if rec.squeeze else x


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------

class ThreadReplica:
    """In-process replica: one serialized worker thread over a private
    :class:`HandleCache`.  The worker serves one accepted ticket per
    micro-batch (determinism contract) and runs deploy/canary commands
    in-band — BETWEEN batches, which is the per-replica drain point the
    rolling deploy relies on."""

    kind = "thread"

    def __init__(self, rid: int, router: "FleetRouter", paths: dict,
                 server_kw: dict, handle_bytes: int | None, device=None):
        from superlu_dist_tpu_torch.testing.chaos import get_fleet_chaos
        self.rid = int(rid)
        self._router = router
        self._cache = HandleCache(handle_bytes, server_kw, device=device)
        self.device = self._cache.device
        for key, path in paths.items():
            self._cache.register(key, path)
        self._lock = make_lock(f"ThreadReplica[{rid}]._lock")
        self._cond = make_condition(f"ThreadReplica[{rid}]._cond",
                                    self._lock)
        self._work: list = []
        self._closed = False
        self._dead = False
        self._quarantined = False
        self._batches = 0
        self._chaos = get_fleet_chaos()   # per-replica monkey state
        self._thread = threading.Thread(
            target=self._worker, name=f"slu-fleet-replica-{rid}",
            daemon=True)
        self._thread.start()

    # -- interface ------------------------------------------------------
    def submit(self, rec: _TicketRec) -> bool:
        with self._cond:
            if self._closed or self._dead or self._quarantined:
                return False
            self._work.append(("serve", rec))
            self._cond.notify_all()
        return True

    def register(self, key, path: str) -> None:
        self._cache.register(key, path)

    def deploy(self, key, path: str) -> bool:
        """Hot-swap ``key`` to ``path`` in-band (between batches);
        returns True when a resident handle was actually swapped."""
        return self._run_cmd(lambda: self._cache.deploy(key, path))

    def canary(self, key, b: np.ndarray) -> np.ndarray:
        """Serve one canary batch through THIS replica, in-band."""
        return self._run_cmd(
            lambda: np.asarray(self._cache.get(key).solve(b, 120.0)))

    def alive(self) -> bool:
        """The liveness verdict (thread analog of ``pid_alive``): the
        worker thread runs and has not simulated a crash.  Slowness is
        never death."""
        with self._lock:
            if self._dead:
                return False
            return self._thread.is_alive() or self._closed

    def routable(self) -> bool:
        with self._lock:
            return not (self._closed or self._dead or self._quarantined)

    def affinity(self, key) -> bool:
        return key in self._cache.resident()

    def describe(self) -> dict:
        with self._lock:
            return {"rid": self.rid, "kind": self.kind,
                    "batches": self._batches, "dead": self._dead,
                    "quarantined": self._quarantined,
                    "cache": self._cache.stats()}

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)
        self._cache.close()

    # -- worker ---------------------------------------------------------
    def _run_cmd(self, fn, timeout: float = 120.0):
        box = {"ok": None, "val": None}
        done = threading.Event()

        def run():
            try:
                box["val"] = fn()
                box["ok"] = True
            except Exception as e:          # noqa: BLE001 — travels back
                box["val"] = e
                box["ok"] = False
            done.set()

        with self._cond:
            if self._closed or self._dead:
                raise SuperLUError(
                    f"fleet replica {self.rid} is not accepting "
                    "commands (closed or failed)")
            self._work.append(("cmd", run))
            self._cond.notify_all()
        if not done.wait(timeout):
            raise SuperLUError(
                f"fleet replica {self.rid} command timed out "
                f"({timeout}s)")
        if not box["ok"]:
            raise box["val"]
        return box["val"]

    def _worker(self):
        with on_device(self.device):
            self._work_loop()

    def _work_loop(self):
        while True:
            with self._cond:
                while not self._work and not self._closed:
                    self._cond.wait(0.1)
                if self._closed and not self._work:
                    return
                if self._dead:
                    return
                kind, item = self._work.pop(0)
            if kind == "cmd":
                item()
                continue
            if self._serve_one(item) is False:
                return                      # simulated crash

    def _serve_one(self, rec: _TicketRec):
        rec_live = not rec.event.is_set() and rec.replica == self.rid
        if not rec_live:
            return None     # re-routed or expired while queued here
        chaos = self._chaos
        if chaos is not None:
            stall = chaos.replica_stall_s(self.rid)
            if stall > 0:
                time.sleep(stall)           # slow, NOT dead
            if chaos.replica_quarantined(self.rid):
                self._mark_quarantined()
                self._router._replica_unroutable(
                    self.rid, "chaos quarantine_replica")
                return None
            with self._lock:
                batches = self._batches
            if chaos.replica_kill_due(self.rid, batches):
                # the thread-replica analog of kill -9: stop serving
                # with every accepted ticket undelivered — the router
                # must re-route them all
                with self._lock:
                    self._dead = True
                self._router._replica_failed(
                    self.rid,
                    cause="chaos kill_replica (simulated SIGKILL)")
                return False
        try:
            srv = self._cache.get(rec.key)
            # same-process replica: the router-minted context IS the
            # parent, so the server's stage spans share its trace id
            t = srv.submit(rec.b,
                           parent=rec.ctx if rec.ctx.enabled else None)
            srv.flush()
            x = None
            while x is None:
                try:
                    x = np.asarray(t.result(timeout=1.0))
                except TimeoutError:
                    with self._lock:
                        gone = self._closed or self._dead
                    if gone:
                        return None     # close/crash purge handles rec
            with self._lock:
                self._batches += 1
            self._router._deliver(rec, x=x, rid=self.rid)
        except (FactorCorruptError, CheckpointError,
                ServerClosedError) as e:
            # handle-level failure: the replica (not the ticket) is the
            # blast radius — quarantine and let the router re-route
            self._mark_quarantined()
            self._router._replica_unroutable(
                self.rid, f"{type(e).__name__}: {e}")
        except Exception as e:              # noqa: BLE001 — per-ticket
            self._router._deliver(rec, err=e, rid=self.rid)
        return None

    def _mark_quarantined(self):
        with self._lock:
            self._quarantined = True


def _replica_child_main(conn, rid: int, paths: dict, server_kw: dict,
                        handle_bytes: int | None, device: str = "cuda"):
    """Process-replica worker: a fresh (spawned) interpreter serving a
    private HandleCache on ``device`` over a pipe — on the card with a
    CUDA context of its own.  One message, one micro-batch — the same
    determinism contract as the thread replica.  Chaos ``kill_replica``
    here is a REAL ``kill -9`` of this process."""
    from superlu_dist_tpu_torch.testing.chaos import get_fleet_chaos
    cache = HandleCache(handle_bytes, server_kw, device=device)
    for key, path in paths.items():
        cache.register(key, path)
    with on_device(cache.device):
        _child_loop(conn, rid, cache, get_fleet_chaos())


def _child_loop(conn, rid, cache, chaos):
    """The process replica's message loop (see _replica_child_main)."""
    batches = 0
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            tag = msg[0]
            if tag == "close":
                break
            if tag == "register":
                _, key, path = msg
                try:
                    cache.register(key, path)
                except Exception:           # noqa: BLE001 — best effort
                    pass
                continue
            if tag == "deploy":
                _, seq, key, path = msg
                try:
                    swapped = cache.deploy(key, path)
                    conn.send(("cmd", seq, True, swapped))
                except Exception as e:      # noqa: BLE001 — travels back
                    conn.send(("cmd", seq, False,
                               f"{type(e).__name__}: {e}"))
                continue
            if tag == "canary":
                _, seq, key, b = msg
                try:
                    x = np.asarray(cache.get(key).solve(b, 120.0))
                    conn.send(("cmd", seq, True, x))
                except Exception as e:      # noqa: BLE001 — travels back
                    conn.send(("cmd", seq, False,
                               f"{type(e).__name__}: {e}"))
                continue
            if tag == "metrics_pull":
                _, seq = msg
                try:
                    from superlu_dist_tpu_torch.obs.metrics import get_metrics
                    m = get_metrics()
                    conn.send(("cmd", seq, True,
                               m.snapshot() if m.enabled else None))
                except Exception as e:      # noqa: BLE001 — travels back
                    conn.send(("cmd", seq, False,
                               f"{type(e).__name__}: {e}"))
                continue
            if tag != "submit":
                continue
            # 5-element frame carries the router-side trace id; the
            # 4-element form is accepted for wire compat (a parent one
            # commit ahead of a child, or vice versa)
            _, token, key, b = msg[:4]
            tid = msg[4] if len(msg) > 4 else ""
            if chaos is not None:
                stall = chaos.replica_stall_s(rid)
                if stall > 0:
                    time.sleep(stall)       # slow, NOT dead
                if chaos.replica_quarantined(rid):
                    conn.send(("quarantined", token,
                               "chaos quarantine_replica"))
                    continue
                if chaos.replica_kill_due(rid, batches):
                    os.kill(os.getpid(), signal.SIGKILL)
            try:
                srv = cache.get(key)
                t = srv.submit(b, parent=parent_ref(tid))
                srv.flush()
                x = np.asarray(t.result(300.0))
                batches += 1
                conn.send(("ok", token, x))
            except (FactorCorruptError, CheckpointError) as e:
                # handle-level failure: quarantine the replica, leave
                # the token undelivered — the parent re-routes it
                conn.send(("quarantined", token,
                           f"{type(e).__name__}: {e}"))
            except Exception as e:          # noqa: BLE001 — per-ticket
                conn.send(("err", token, type(e).__name__, str(e)))
    finally:
        try:
            # final metrics push: the parent absorbs whatever this
            # replica counted, even across a graceful close (a kill -9
            # forfeits it — the delta-merge makes that loss bounded)
            from superlu_dist_tpu_torch.obs.metrics import get_metrics
            m = get_metrics()
            if m.enabled:
                conn.send(("metrics", m.snapshot()))
        except Exception:                   # noqa: BLE001 — teardown
            pass
        try:
            cache.close()
        except Exception:                   # noqa: BLE001 — teardown
            pass


class ProcessReplica:
    """Subprocess replica behind the same interface: a spawned worker
    process (CUDA cannot be used in a forked child) serving over a duplex
    pipe, judged alive by :func:`pid_alive` — the kill -9 failure
    domain.  The child loads its handles onto ``device`` (the card
    unless the caller asks for the CPU)."""

    kind = "process"

    def __init__(self, rid: int, router: "FleetRouter", paths: dict,
                 server_kw: dict, handle_bytes: int | None, device=None):
        from superlu_dist_tpu_torch.utils.options import resolve_device
        self.rid = int(rid)
        self._router = router
        self.device = resolve_device("cuda" if device is None else device)
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_replica_child_main,
            args=(child, rid, dict(paths), dict(server_kw),
                  handle_bytes, str(self.device)),
            name=f"slu-fleet-replica-{rid}", daemon=True)
        self._proc.start()
        child.close()
        self._lock = make_lock(f"ProcessReplica[{rid}]._lock")
        self._send_lock = make_lock(f"ProcessReplica[{rid}]._send_lock")
        self._closed = False
        self._dead = False
        self._quarantined = False
        self._keys_routed: set = set()      # parent-side affinity guess
        self._cmd_seq = 0
        self._cmd_boxes: dict = {}          # seq -> (event, box)
        self._collector = threading.Thread(
            target=self._collect, name=f"slu-fleet-collect-{rid}",
            daemon=True)
        self._collector.start()

    @property
    def pid(self) -> int:
        return int(self._proc.pid or -1)

    # -- interface ------------------------------------------------------
    def _send(self, msg) -> bool:
        with self._send_lock:
            try:
                self._conn.send(msg)
            except (OSError, ValueError, BrokenPipeError):
                return False
        return True

    def submit(self, rec: _TicketRec) -> bool:
        with self._lock:
            if self._closed or self._dead or self._quarantined:
                return False
            self._keys_routed.add(rec.key)
        return self._send(("submit", rec.token, rec.key, rec.b,
                           rec.ctx.trace_id))

    def register(self, key, path: str) -> None:
        self._send(("register", key, path))

    def _run_cmd(self, msg_head: tuple, timeout: float = 120.0):
        done = threading.Event()
        box = {}
        with self._lock:
            if self._closed or self._dead:
                raise SuperLUError(
                    f"fleet replica {self.rid} is not accepting "
                    "commands (closed or failed)")
            self._cmd_seq += 1
            seq = self._cmd_seq
            self._cmd_boxes[seq] = (done, box)
        if not self._send((msg_head[0], seq) + msg_head[1:]):
            raise SuperLUError(
                f"fleet replica {self.rid} pipe is down")
        if not done.wait(timeout):
            raise SuperLUError(
                f"fleet replica {self.rid} command timed out "
                f"({timeout}s)")
        if not box.get("ok"):
            raise SuperLUError(str(box.get("val")))
        return box.get("val")

    def deploy(self, key, path: str) -> bool:
        return bool(self._run_cmd(("deploy", key, path)))

    def poll_metrics(self, timeout: float = 5.0):
        """Pull the child's metrics snapshot over the command channel
        and fold the delta into the router registry (the process-
        replica aggregation satellite).  Returns the raw snapshot."""
        snap = self._run_cmd(("metrics_pull",), timeout=timeout)
        if snap:
            self._router._absorb_replica_metrics(self.rid, snap)
        return snap

    def canary(self, key, b: np.ndarray) -> np.ndarray:
        return np.asarray(self._run_cmd(("canary", key, b)))

    def alive(self) -> bool:
        """The liveness verdict on the replica process itself: pid exists
        and is not a zombie.  A stalled-but-alive replica is NEVER
        declared failed."""
        with self._lock:
            if self._dead:
                return False
            if self._closed:
                return True
        return pid_alive(self.pid)

    def routable(self) -> bool:
        with self._lock:
            if self._closed or self._dead or self._quarantined:
                return False
        return pid_alive(self.pid)

    def affinity(self, key) -> bool:
        with self._lock:
            return key in self._keys_routed

    def describe(self) -> dict:
        with self._lock:
            return {"rid": self.rid, "kind": self.kind, "pid": self.pid,
                    "dead": self._dead,
                    "quarantined": self._quarantined,
                    "keys_routed": sorted(map(repr, self._keys_routed))}

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
        self._send(("close",))
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(1.0)
        try:
            self._conn.close()
        except OSError:
            pass
        self._collector.join(1.0)

    # -- collector ------------------------------------------------------
    def _collect(self):
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError, ValueError):
                with self._lock:
                    was_closed = self._closed or self._dead
                    self._dead = True
                self._fail_cmds_locked_free()
                if not was_closed:
                    self._router._replica_failed(
                        self.rid,
                        cause=f"pipe to replica pid {self.pid} closed "
                              "(process dead)",
                        pid=self.pid)
                return
            tag = msg[0]
            if tag == "ok":
                self._router._deliver_token(msg[1], x=msg[2],
                                            rid=self.rid)
            elif tag == "err":
                self._router._deliver_token(
                    msg[1],
                    err=_RemoteServeError(msg[2], msg[3], self.rid),
                    rid=self.rid)
            elif tag == "quarantined":
                with self._lock:
                    already = self._quarantined
                    self._quarantined = True
                if not already:
                    self._router._replica_unroutable(self.rid, msg[2])
            elif tag == "metrics":
                self._router._absorb_replica_metrics(self.rid, msg[1])
            elif tag == "cmd":
                _, seq, ok, val = msg
                with self._lock:
                    ent = self._cmd_boxes.pop(seq, None)
                if ent is not None:
                    done, box = ent
                    box["ok"] = ok
                    box["val"] = val
                    done.set()

    def _fail_cmds_locked_free(self):
        """Resolve every pending command box after the pipe died (no
        command may hang on a dead replica)."""
        with self._lock:
            boxes = list(self._cmd_boxes.values())
            self._cmd_boxes.clear()
        for done, box in boxes:
            box["ok"] = False
            box["val"] = f"replica {self.rid} died mid-command"
            done.set()


# ---------------------------------------------------------------------------
# the routing front
# ---------------------------------------------------------------------------

class FleetRouter:
    """Health-checked routing front over N multi-handle replicas.

    Parameters
    ----------
    bundles : dict
        ``{key: persist bundle dir}`` registered on every replica at
        construction (more via :meth:`register`).
    n_replicas / kind :
        Fleet shape; None reads ``SLU_TPU_FLEET_REPLICAS`` /
        ``SLU_TPU_FLEET_KIND`` (``thread`` or ``process``).
    queue_max :
        Fleet-level admission cap in undelivered COLUMNS; None reads
        ``SLU_TPU_FLEET_QUEUE_MAX`` (0 = unbounded).
    deadline_s :
        End-to-end per-ticket deadline; None reads
        ``SLU_TPU_FLEET_DEADLINE_MS`` (0 = off).
    handle_bytes :
        Per-replica resident-handle byte budget; None reads
        ``SLU_TPU_FLEET_HANDLE_BYTES``.
    health_s :
        Health-monitor poll period; None reads
        ``SLU_TPU_FLEET_HEALTH_S``.
    server_kw :
        SolveServer keywords for replica-loaded handles (defaults to
        :data:`FLEET_SERVER_KW` — the determinism contract).
    device :
        Where every replica loads its handles: None is the card (CUDA
        without a card raises), ``"cpu"`` the CPU; passed down to process
        replicas.  On the card the CUDA kernels are built here, before
        any process replica starts, so no two children compile.
    """

    def __init__(self, bundles: dict | None = None,
                 n_replicas: int | None = None, kind: str | None = None,
                 queue_max: int | None = None,
                 deadline_s: float | None = None,
                 handle_bytes: int | None = None,
                 health_s: float | None = None,
                 server_kw: dict | None = None, device=None):
        from superlu_dist_tpu_torch.utils.options import (env_float, env_int,
                                                          env_str,
                                                          resolve_device)
        if n_replicas is None:
            n_replicas = env_int("SLU_TPU_FLEET_REPLICAS")
        if kind is None:
            kind = env_str("SLU_TPU_FLEET_KIND")
        if kind not in ("thread", "process"):
            raise SuperLUError(
                f"fleet replica kind must be 'thread' or 'process', "
                f"got {kind!r}")
        if queue_max is None:
            queue_max = env_int("SLU_TPU_FLEET_QUEUE_MAX")
        if deadline_s is None:
            deadline_s = env_float("SLU_TPU_FLEET_DEADLINE_MS") / 1000.0
        if health_s is None:
            health_s = env_float("SLU_TPU_FLEET_HEALTH_S")
        self.n_replicas = int(n_replicas)
        if self.n_replicas < 1:
            raise SuperLUError("a fleet needs at least one replica")
        self.device = resolve_device("cuda" if device is None else device)
        if kind == "process" and self.device.type == "cuda":
            from superlu_dist_tpu_torch.numeric import kernels
            kernels.build()
        self.kind = kind
        self.queue_max = int(queue_max)
        self.deadline_s = float(deadline_s)
        self.health_s = float(health_s)
        self._server_kw = dict(FLEET_SERVER_KW if server_kw is None
                               else server_kw)
        self._handle_bytes = handle_bytes
        self._lock = make_lock("FleetRouter._lock")
        self._cond = make_condition("FleetRouter._cond", self._lock)
        self._registry: dict = {}
        self._undelivered: dict = {}        # token -> _TicketRec
        self._pending_cols = 0
        self._seq = 0
        self._rr = 0                        # round-robin tiebreak
        self._closed = False
        self._draining = False
        self._failed: set = set()
        self._unroutable_seen: set = set()
        # counters (under _lock; metrics registry mirrors when on)
        self._requests = 0
        self._delivered = 0
        self._errors = 0
        self._shed = 0
        self._deadline_miss = 0
        self._reroutes = 0
        self._failovers = 0
        self._deploys = 0
        self._refactors = 0
        self._rollbacks = 0
        m = get_metrics()
        self._metrics = m if m.enabled else None
        # latched once (the NULL_TRACER discipline): submit mints a
        # TicketContext only when tracing is on
        t = get_tracer()
        self._tracer = t if t.enabled else None
        self._accounter = get_accounter()    # always-on latency floor
        self._slo = SLOEvaluator()
        self._slo_state: dict = {}
        self._replica_snaps: dict = {}      # rid -> last absorbed snap
        bundles = dict(bundles or {})
        self._registry.update(
            {k: str(p) for k, p in bundles.items()})
        cls = ThreadReplica if kind == "thread" else ProcessReplica
        self._replicas = [
            cls(rid, self, self._registry, self._server_kw,
                handle_bytes, device=self.device)
            for rid in range(self.n_replicas)]
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="slu-fleet-monitor",
            daemon=True)
        self._monitor.start()
        self._gauge_healthy()

    # ------------------------------------------------------------------
    def register(self, key, bundle_path: str) -> dict:
        """Bind ``key`` to a persist bundle fleet-wide.  Returns the
        bundle's lu_meta peek."""
        from superlu_dist_tpu_torch.persist.serial import lu_meta
        meta = lu_meta(str(bundle_path))
        with self._lock:
            self._registry[key] = str(bundle_path)
        for r in self._replicas:
            r.register(key, str(bundle_path))
        return meta

    def keys(self) -> list:
        with self._lock:
            return list(self._registry)

    # ------------------------------------------------------------------
    def submit(self, key, b: np.ndarray) -> FleetTicket:
        """Route one right-hand side for matrix ``key`` — (n,) or
        (n, k) — to a healthy replica.  Admission control runs HERE:
        closed fleet → :class:`ServerClosedError`; draining or past the
        fleet column cap → :class:`ServeOverloadError` (reason
        ``draining`` / ``fleet_queue_full``) before any replica sees
        the work."""
        t0 = time.perf_counter()
        b = np.asarray(b)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        if b2.ndim != 2 or b2.shape[1] == 0:
            raise SuperLUError(
                f"rhs shape {b.shape} does not fit a fleet submit "
                "(need (n,) or (n, k>0))")
        k = b2.shape[1]
        m = self._metrics
        with self._lock:
            if self._closed:
                raise ServerClosedError("FleetRouter is closed")
            if key not in self._registry:
                raise SuperLUError(
                    f"matrix key {key!r} is not registered with this "
                    "fleet (register(key, bundle_path) first)")
            if self._draining:
                self._shed += 1
                if m is not None:
                    m.inc("slu_serve_shed_total", 1.0,
                          reason="draining")
                raise ServeOverloadError(k, self._pending_cols,
                                         self.queue_max,
                                         reason="draining")
            if self.queue_max > 0 and \
                    self._pending_cols + k > self.queue_max:
                self._shed += 1
                if m is not None:
                    m.inc("slu_serve_shed_total", 1.0,
                          reason="fleet_queue_full")
                raise ServeOverloadError(k, self._pending_cols,
                                         self.queue_max,
                                         reason="fleet_queue_full")
            self._seq += 1
            rec = _TicketRec(self._seq, key, b2, squeeze)
            rec.t_submit = t0
            rec.t_routed = t0
            if self._tracer is not None:
                rec.ctx = TicketContext(f"f{rec.token}", t0)
                rec.ctx.note(nrhs=k, key=str(key))
            if self.deadline_s > 0:
                rec.deadline_s = self.deadline_s
                rec.t_deadline = t0 + self.deadline_s
            self._undelivered[rec.token] = rec
            self._pending_cols += k
            self._requests += 1
        if m is not None:
            m.inc("slu_fleet_requests_total", 1.0)
            m.inc("slu_fleet_columns_total", float(k))
        self._route(rec)
        return FleetTicket(rec, self)

    def solve(self, key, b: np.ndarray,
              timeout: float | None = None) -> np.ndarray:
        """submit() + result(): the one-call convenience path."""
        return self.submit(key, b).result(timeout)

    # ------------------------------------------------------------------
    def _pick_locked(self, key, exclude):
        """Under the lock: choose a routable replica — handle affinity
        first, least outstanding columns second, round-robin third.
        Returns the replica index or None when no routable replica
        remains."""
        cands = [i for i, r in enumerate(self._replicas)
                 if i not in exclude and r.routable()]
        if not cands:
            return None
        out = {i: 0 for i in cands}
        for rec in self._undelivered.values():
            if rec.replica in out and not rec.event.is_set():
                out[rec.replica] += rec.k
        with_key = [i for i in cands if self._replicas[i].affinity(key)]
        pool = with_key or cands
        best = min(out[i] for i in pool)
        pool = [i for i in pool if out[i] == best]
        self._rr += 1
        return pool[self._rr % len(pool)]

    def _route(self, rec: _TicketRec, rerouted: bool = False) -> None:
        """Assign ``rec`` to a replica (retrying refusals against the
        remaining healthy set).  When NO routable replica remains the
        ticket is delivered a structured :class:`ReplicaFailureError`
        instead of hanging — the only time a fleet client sees a
        replica failure."""
        m = self._metrics
        while True:
            with self._lock:
                if rec.event.is_set() or \
                        rec.token not in self._undelivered:
                    return
                over_budget = rec.attempts > 2 * self.n_replicas + 2
                rid = (None if over_budget else
                       self._pick_locked(rec.key, exclude=rec.tried))
                if rid is None and rec.tried and not over_budget:
                    # every replica tried once: allow a second lap over
                    # whatever is still routable (a replica may have
                    # refused transiently)
                    rid = self._pick_locked(rec.key, exclude=())
                if rid is not None:
                    rec.replica = rid
                    rec.tried.add(rid)
                    rec.attempts += 1
            if rid is None:
                err = ReplicaFailureError(
                    rec.replica, [rec.token],
                    cause="no healthy replica remains to re-route to",
                    kind=self.kind)
                self._deliver(rec, err=err, rid=rec.replica)
                return
            if self._replicas[rid].submit(rec):
                if rec.ctx.enabled:
                    # stage edge: routing time since submit (or since
                    # the previous route on a failover lap)
                    tnow = time.perf_counter()
                    rec.ctx.stage("reroute" if rerouted else "route",
                                  rec.t_routed, tnow - rec.t_routed)
                    rec.ctx.note(replica=rid)
                    rec.t_routed = tnow
                if rerouted:
                    with self._lock:
                        self._reroutes += 1
                    if m is not None:
                        m.inc("slu_fleet_reroutes_total", 1.0)
                return
            rerouted = True     # refusal → the next lap is a re-route

    # ------------------------------------------------------------------
    def _deliver(self, rec: _TicketRec, x=None, err=None,
                 rid: int = -1) -> bool:
        """First-wins delivery under the idempotent retry token: a
        duplicate delivery (original replica raced its own failover) is
        dropped, which is what makes re-routing safe."""
        with self._lock:
            if rec.event.is_set() or \
                    self._undelivered.pop(rec.token, None) is None:
                return False
            self._pending_cols -= rec.k
            if err is not None:
                rec.error = err
                self._errors += 1
            else:
                rec.x = x
                self._delivered += 1
            rec.event.set()
            self._cond.notify_all()
        t_end = time.perf_counter()
        lat = t_end - rec.t_submit
        # the always-on latency floor: one histogram increment per
        # delivered (or errored) ticket, keyed by traffic class
        self._accounter.observe(rec.k, lat, klass="fleet")
        ctx = rec.ctx
        if ctx.enabled:
            ctx.stage("serve", rec.t_routed, t_end - rec.t_routed)
            if err is not None:
                ctx.note(error=type(err).__name__)
            ctx.emit(self._tracer, t_end, name="fleet-request")
        m = self._metrics
        if m is not None:
            m.observe("slu_fleet_route_seconds", lat)
        return True

    def _deliver_token(self, token: int, x=None, err=None,
                       rid: int = -1) -> bool:
        with self._lock:
            rec = self._undelivered.get(token)
        if rec is None:
            return False
        return self._deliver(rec, x=x, err=err, rid=rid)

    def _expire(self, rec: _TicketRec, now: float) -> bool:
        """End-to-end deadline expiry (monitor sweep or the waiting
        ticket itself)."""
        if rec.t_deadline is None or now < rec.t_deadline:
            return False
        err = ServeDeadlineError(rec.deadline_s, now - rec.t_submit,
                                 rec.k)
        if self._deliver(rec, err=err, rid=rec.replica):
            with self._lock:
                self._deadline_miss += 1
            if self._metrics is not None:
                self._metrics.inc("slu_serve_deadline_miss_total", 1.0)
            # _deliver recorded the final serve stage; attach the
            # timings so the postmortem names the stage that ate the
            # budget, then dump — outside every lock
            if rec.ctx.enabled:
                err.ticket_stages = rec.ctx.stages_ms() or None
                err.trace_id = rec.ctx.trace_id
            err.flight_postmortem()
            return True
        return False

    # ------------------------------------------------------------------
    def _replica_failed(self, rid: int, cause: str,
                        pid: int = -1) -> None:
        """A replica is DEAD (pid gone / pipe closed / worker crashed):
        re-route every ticket it had accepted but not delivered.  The
        :class:`ReplicaFailureError` constructed here dumps the
        flight-recorder postmortem naming the dead replica and the
        re-routed ticket set — the tickets themselves never see it
        while a healthy replica remains."""
        with self._lock:
            if self._closed or rid in self._failed:
                return
            self._failed.add(rid)
            victims = [rec for rec in self._undelivered.values()
                       if rec.replica == rid and not rec.event.is_set()]
            self._failovers += 1
        # construct (and flight-dump) OUTSIDE the lock: the postmortem
        # write must not stall submit/deliver
        ReplicaFailureError(rid, [rec.token for rec in victims],
                            cause=cause, pid=pid, kind=self.kind)
        m = self._metrics
        if m is not None:
            m.inc("slu_fleet_failovers_total", 1.0)
        self._gauge_healthy()
        for rec in victims:
            self._route(rec, rerouted=True)

    def _replica_unroutable(self, rid: int, cause: str) -> None:
        """A replica QUARANTINED (corrupt handle, chaos): alive but
        unroutable — re-route its undelivered tickets, route around it
        from now on.  Same evidence trail as a death, kind
        ``quarantine``."""
        with self._lock:
            if self._closed or rid in self._unroutable_seen:
                return
            self._unroutable_seen.add(rid)
            victims = [rec for rec in self._undelivered.values()
                       if rec.replica == rid and not rec.event.is_set()]
            self._failovers += 1
        ReplicaFailureError(rid, [rec.token for rec in victims],
                            cause=cause, kind="quarantine")
        m = self._metrics
        if m is not None:
            m.inc("slu_fleet_failovers_total", 1.0)
        self._gauge_healthy()
        for rec in victims:
            self._route(rec, rerouted=True)

    def _gauge_healthy(self) -> None:
        if self._metrics is not None:
            n = sum(1 for r in self._replicas if r.routable())
            self._metrics.set("slu_fleet_replicas_healthy", float(n))

    def _monitor_loop(self):
        """Health monitor: replica liveness probes (the pid/thread
        verdict — NEVER latency, so a slow replica yields zero false
        failovers), deadline sweeps, and the healthy-replicas gauge."""
        while not self._monitor_stop.wait(self.health_s):
            for rid, r in enumerate(self._replicas):
                with self._lock:
                    seen = rid in self._failed or self._closed
                if not seen and not r.alive():
                    self._replica_failed(
                        rid, cause="liveness probe: replica "
                        f"{r.kind} is dead",
                        pid=getattr(r, "pid", -1))
            if self.deadline_s > 0:
                now = time.perf_counter()
                with self._lock:
                    due = [rec for rec in self._undelivered.values()
                           if rec.t_deadline is not None
                           and now >= rec.t_deadline]
                for rec in due:
                    self._expire(rec, now)
            self._gauge_healthy()
            self._heartbeat_obs()

    def _heartbeat_obs(self) -> None:
        """Observability heartbeat (piggybacks the health poll): pull
        process-replica child metrics into the router registry, publish
        the latency quantile gauges, evaluate the SLO burn rate, and
        refresh the metrics export snapshot — so ``slu_top`` reading
        the export file sees a live fleet, not an atexit one."""
        m = self._metrics
        if m is not None and self.kind == "process":
            for r in self._replicas:
                try:
                    r.poll_metrics()
                except Exception:           # noqa: BLE001 — best effort
                    pass
        if m is not None:
            self._accounter.publish(m)
        if self._slo.armed:
            state = self._slo.evaluate(self._accounter)
            with self._lock:
                self._slo_state = state
            if m is not None:
                for key, s in state.items():
                    klass, _, nb = key.partition("|")
                    labels = {"class": klass, "nrhs": nb}
                    m.set("slu_slo_burn_rate", float(s["burn"]),
                          **labels)
                    m.set("slu_slo_ok", 1.0 if s["ok"] else 0.0,
                          **labels)
        if m is not None:
            m.dump_now()

    def _absorb_replica_metrics(self, rid: int, snap: dict) -> None:
        """Fold a process-replica child's metrics snapshot into the
        router registry as a DELTA vs the last snapshot absorbed from
        that replica — heartbeat pulls and the teardown push both land
        here, so double counting is structurally impossible."""
        m = self._metrics
        if m is None or not snap:
            return
        with self._lock:
            base = self._replica_snaps.get(rid)
            self._replica_snaps[rid] = snap
        m.merge_snapshot(snap, base=base)

    # ------------------------------------------------------------------
    def deploy(self, bundle_path: str, key=None,
               canary_b: np.ndarray | None = None, a=None,
               berr_max: float = 0.0, preflight: bool = True) -> dict:
        """Rolling deploy of a new bundle for ``key`` (defaults to the
        fleet's only key): one replica at a time, swap behind the
        per-replica drain point (the in-band command — queued + future
        tickets served by the new handle, in-flight finishes on the
        old, zero dropped), then gate on a canary batch served through
        THAT replica: finite X always, componentwise BERR ≤
        ``berr_max`` when ``a`` (the new matrix) and a positive gate
        are given.  Any load/scrub/canary failure rolls every
        already-swapped replica back to the previous bundle and raises
        :class:`DeployRollbackError` — the fleet never serves a mix of
        good and poisoned factors.  With ``preflight`` (default) the
        bundle is side-loaded and canaried in the ROUTER first, so a
        poisoned bundle is rejected before any replica ever swaps to it
        (zero exposure); the per-replica canary still guards
        replica-local failures during the roll.  Returns a summary
        dict."""
        from superlu_dist_tpu_torch.persist.serial import lu_meta
        with self._lock:
            if self._closed:
                raise ServerClosedError("FleetRouter is closed")
            if key is None:
                if len(self._registry) != 1:
                    raise SuperLUError(
                        "deploy(bundle) needs key=... when the fleet "
                        f"serves {len(self._registry)} keys")
                key = next(iter(self._registry))
            if key not in self._registry:
                raise SuperLUError(
                    f"matrix key {key!r} is not registered with this "
                    "fleet")
            old_path = self._registry[key]
        bundle_path = str(bundle_path)
        try:
            meta = lu_meta(bundle_path)     # manifest sanity, pre-flight
        except Exception as e:
            self._note_rollback()
            raise DeployRollbackError(key, bundle_path, "load",
                                      cause=f"{type(e).__name__}: {e}")
        if canary_b is None:
            # deterministic default canary: a ones RHS of the bundle's
            # n in the bundle's factor dtype
            try:
                dt = np.dtype(meta.get("factor_dtype", "float64"))
            except TypeError:
                dt = np.float64
            canary_b = np.ones(int(meta["n"]), dtype=dt)

        def _gate(x, where: str) -> None:
            if not np.isfinite(x).all():
                raise SuperLUError(
                    f"{where} canary batch produced non-finite X")
            if a is not None and berr_max > 0:
                from superlu_dist_tpu_torch.refine.ir import request_berrs
                berr = float(request_berrs(a, canary_b, x).max())
                if berr > berr_max:
                    raise SuperLUError(
                        f"{where} canary berr {berr:.3e} exceeds the "
                        f"{berr_max:.3e} gate")

        if preflight:
            # side-load + canary in the ROUTER before any replica swaps:
            # a poisoned bundle never reaches a serving handle
            from superlu_dist_tpu_torch.persist.serial import load_lu
            try:
                # digest-verified (scrub), on the fleet's device
                lu_new = load_lu(bundle_path, device=self.device)
            except Exception as e:              # noqa: BLE001 — gate
                self._note_rollback()
                raise DeployRollbackError(
                    key, bundle_path, "load",
                    cause=f"{type(e).__name__}: {e}")
            try:
                _gate(np.asarray(lu_new.solve_factored(canary_b)),
                      "preflight")
            except Exception as e:              # noqa: BLE001 — gate
                self._note_rollback()
                raise DeployRollbackError(
                    key, bundle_path, "canary",
                    cause=f"{type(e).__name__}: {e}")
            finally:
                del lu_new
        swapped: list = []
        for rid, r in enumerate(self._replicas):
            if not r.routable():
                continue
            try:
                r.deploy(key, bundle_path)
                swapped.append(rid)
                _gate(r.canary(key, canary_b), f"replica {rid}")
            except Exception as e:          # noqa: BLE001 — roll back
                restored = []
                for back in swapped:
                    try:
                        self._replicas[back].deploy(key, old_path)
                        restored.append(back)
                    except Exception:       # noqa: BLE001 — best effort
                        pass
                self._note_rollback()
                # deploy() failing = the swap's digest-verified load /
                # scrub rejected the bundle; past it, the canary did
                stage = "canary" if rid in swapped else "load"
                raise DeployRollbackError(
                    key, bundle_path, stage, replica=rid,
                    rolled_back=restored,
                    cause=f"{type(e).__name__}: {e}")
        with self._lock:
            self._registry[key] = bundle_path
            self._deploys += 1
        for r in self._replicas:
            r.register(key, bundle_path)
        if self._metrics is not None:
            self._metrics.inc("slu_fleet_deploys_total", 1.0)
        return {"key": key, "bundle": bundle_path,
                "replicas_swapped": swapped, "previous": old_path}

    def _note_rollback(self):
        with self._lock:
            self._rollbacks += 1
        if self._metrics is not None:
            self._metrics.inc("slu_fleet_rollbacks_total", 1.0)

    # ------------------------------------------------------------------
    def refactor(self, key, new_values, canary_b: np.ndarray | None = None,
                 berr_max: float = 0.0, workdir: str | None = None,
                 preflight: bool = True) -> dict:
        """Rolling same-pattern refactorization of the fleet's handle
        for ``key``: the registered bundle is loaded router-side, its
        numeric phase re-run over ``new_values`` (same-pattern
        SparseCSR) through the crash-consistent
        ``drivers.gssvx.refactor`` pipeline — symbolic, plan, and
        compiled programs reused, BERR-canaried, adopted only on
        success — persisted as a sibling bundle, and rolled across the
        replicas one at a time through the :meth:`deploy` drain-point +
        canary machinery (zero dropped tickets; values cross the pipe
        as a bundle, the replica protocol is unchanged).  Failure at
        ANY stage raises
        :class:`~superlu_dist_tpu_torch.utils.errors.RefactorRollbackError`
        with every already-swapped replica restored to the previous
        bundle, which keeps serving — the fleet never mixes old and new
        factors.  Pattern drift raises ``PatternMismatchError`` before
        anything is touched.  Returns the :meth:`deploy` summary dict
        plus the new bundle path."""
        from superlu_dist_tpu_torch.drivers.gssvx import refactor as _refactor
        from superlu_dist_tpu_torch.persist.serial import load_lu, save_lu
        with self._lock:
            if self._closed:
                raise ServerClosedError("FleetRouter is closed")
            if key not in self._registry:
                raise SuperLUError(
                    f"matrix key {key!r} is not registered with this "
                    "fleet")
            old_path = self._registry[key]
            seq = self._refactors + self._rollbacks
        if self._metrics is not None:
            self._metrics.inc("slu_fleet_refactor_total", 1.0)
        try:
            lu = load_lu(old_path, device=self.device)
        except Exception as e:              # noqa: BLE001 — gate
            self._note_rollback()
            raise RefactorRollbackError(
                key, "load", cause=f"{type(e).__name__}: {e}")
        try:
            with on_device(self.device):
                _refactor(lu, new_values, canary_b=canary_b,
                          berr_max=berr_max)
        except RefactorRollbackError as e:
            # the shadow factorization/canary already rolled back at
            # the handle level; nothing was persisted, no replica saw it
            self._note_rollback()
            raise RefactorRollbackError(
                key, e.stage, cause=e.cause or "handle-level refactor "
                "rolled back", berr=e.berr,
                berr_target=e.berr_target) from e
        new_path = (os.path.join(workdir, f"refactor-{seq:04d}")
                    if workdir is not None
                    else f"{old_path}.refactor-{seq:04d}")
        try:
            save_lu(lu, new_path)
        except Exception as e:              # noqa: BLE001 — gate
            self._note_rollback()
            raise RefactorRollbackError(
                key, "persist", cause=f"{type(e).__name__}: {e}")
        a_gate = lu.a if berr_max > 0 else None
        try:
            summary = self.deploy(new_path, key=key, canary_b=canary_b,
                                  a=a_gate, berr_max=berr_max,
                                  preflight=preflight)
        except DeployRollbackError as e:
            # deploy() already restored every swapped replica and noted
            # the rollback; surface it under the refactor contract
            raise RefactorRollbackError(
                key, e.stage, replica=e.replica,
                rolled_back=e.rolled_back, cause=e.cause) from e
        with self._lock:
            self._refactors += 1
        if self._metrics is not None:
            self._metrics.inc("slu_fleet_refactor_adopted_total", 1.0)
        summary["previous"] = old_path
        summary["bundle"] = new_path
        return summary

    # ------------------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Reject new submits (``ServeOverloadError`` reason
        ``draining``) while finishing everything undelivered.  True
        once empty."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            self._draining = True
            while self._undelivered:
                left = None if end is None else end - time.perf_counter()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(min(left, 0.5) if left is not None
                                else 0.5)
            return True

    def resume(self) -> "FleetRouter":
        with self._lock:
            self._draining = False
        return self

    def close(self, timeout: float = 30.0) -> None:
        """Shut the fleet down: stop the monitor, close every replica,
        then deliver :class:`ServerClosedError` to every still-
        undelivered ticket — a fleet waiter can never hang on a fleet
        that no longer exists (the server-tier close contract, lifted)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._monitor_stop.set()
        self._monitor.join(min(timeout, 5.0))
        for r in self._replicas:
            r.close(timeout=timeout / max(len(self._replicas), 1))
        with self._lock:
            recs = list(self._undelivered.values())
            self._undelivered.clear()
            self._pending_cols = 0
        for rec in recs:
            if not rec.event.is_set():
                rec.error = ServerClosedError(
                    "FleetRouter closed before this ticket was "
                    "delivered")
                rec.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            st = {
                "replicas": self.n_replicas,
                "kind": self.kind,
                "replicas_failed": sorted(self._failed),
                "requests": self._requests,
                "delivered": self._delivered,
                "errors": self._errors,
                "shed": self._shed,
                "deadline_miss": self._deadline_miss,
                "reroutes": self._reroutes,
                "failovers": self._failovers,
                "deploys": self._deploys,
                "refactors": self._refactors,
                "rollbacks": self._rollbacks,
                "pending_cols": self._pending_cols,
                "queue_max": self.queue_max,
                "deadline_s": self.deadline_s,
                "keys": len(self._registry),
                "closed": self._closed,
                "draining": self._draining,
                "slo": dict(self._slo_state),
            }
        st["replicas_healthy"] = sum(
            1 for r in self._replicas if r.routable())
        st["replica_detail"] = [r.describe() for r in self._replicas]
        return st
