"""Micro-batching solve server — the serving tier over a factored handle.

Port of the JAX package's ``serve/server.py``.  ``SolveServer`` owns one
factored :class:`LUFactorization` (taken live from a ``gssvx`` result,
or loaded zero-refactor from a ``persist/`` bundle via
:meth:`SolveServer.from_bundle` — FACT time stays 0.0) and turns "one
matrix, one solve" into a request/response loop:

* callers :meth:`submit` right-hand-side columns (original labeling,
  ``A·x = b``) and get a :class:`SolveTicket` back immediately;
* a dispatcher thread coalesces pending columns into micro-batches
  **keyed to the device solver's nrhs buckets** (solve/plan.py) — the
  oldest pending request is held open for at most
  ``SLU_TPU_SERVE_MAX_WAIT_MS`` so concurrent traffic lands in one
  device dispatch instead of many, and a batch dispatches early the
  moment it can fill ``SLU_TPU_SERVE_MAX_BATCH`` columns (default: the
  nrhs bucket cap);
* each batch is ONE solve through the handle — on the card one
  ``DeviceSolver`` dispatch, a replay of the bucket's two sweep CUDA
  graphs (captured at the bucket's first batch) — whose results are
  scattered back to the submitting tickets.

The server runs on the device of the handle it is given: its dispatcher
and scrubber threads make that device current for themselves, whatever
the constructing thread's current device is.  A batch that fails on the
card fails its tickets with the structured errors below; nothing is
routed to the host.

Requests wider than the batch cap are column-split across consecutive
batches transparently — a ticket completes when all its columns have.

Reliability layer:

* **Admission control + load shedding** — ``SLU_TPU_SERVE_QUEUE_MAX``
  bounds the pending-column queue (excess submits shed with
  :class:`ServeOverloadError` instead of queueing forever) and
  ``SLU_TPU_SERVE_DEADLINE_MS`` arms a per-request deadline (columns
  still queued past it expire with :class:`ServeDeadlineError` —
  checked by the dispatcher AND by the waiting ticket itself, so a
  stalled dispatcher cannot hang an expired waiter).  :meth:`drain`
  finishes in-flight work while rejecting new submissions.
* **Poisoned-request isolation** — a batch whose solve produces
  non-finite columns (or raises ``NumericBreakdownError``) is bisected
  to the offending columns; the healthy columns are re-served at the
  ORIGINAL batch width, which keeps them bit-identical to an unpoisoned
  dispatch (per-column independence of the batched sweeps; the width
  selects the bucket, hence the graph and the cuBLAS algorithms), and
  only the offending tickets fail, with :class:`ServePoisonedError`
  naming their columns.  ``SLU_TPU_SERVE_BERR_MAX`` additionally gates
  per-request residual quality: a completing ticket whose componentwise
  berr exceeds the gate is routed through a per-ticket iterative-
  refinement rung (``refine/ir.refine_ticket``) before delivery — on the
  card with its residuals through ``csr_spmv`` (``DeviceSpMV``) for a
  matrix with at least ``DEVICE_SPMV_MIN_NNZ`` entries, as the driver's
  refinement does.
* **Hot handle swap + factor scrubbing** — :meth:`swap` atomically
  replaces the factored handle between batches (queued tickets are
  served by the new handle; nothing is dropped — the refactor-on-
  degrade path), and ``SLU_TPU_SERVE_SCRUB_S`` arms a background
  scrubber that re-hashes the handle's resident panel stacks against
  their persist-bundle sha256 digests (a copy of every front to the
  host, hashed OUTSIDE the server lock, so a scrub never stalls
  dispatch), quarantining the handle with :class:`FactorCorruptError`
  on mismatch instead of silently serving garbage X.

Observability: every batch runs under a ``serve-batch`` dispatch span
(the device solve's own ``device-solve`` kernel span and ``solve-d2h``
comm span nest inside it), and the metrics registry (obs/metrics.py,
``SLU_TPU_METRICS``) accumulates the serving-grade series —
``slu_serve_requests_total`` / ``_columns_total`` / ``_batches_total``
/ ``_errors_total`` / ``_shed_total`` / ``_deadline_miss_total`` /
``_poisoned_total`` / ``_refined_total`` / ``_swaps_total`` /
``_scrub_{runs,failures}_total`` counters, the ``slu_serve_queue_depth``
gauge, and ``slu_serve_request_seconds`` / ``slu_serve_batch_fill`` /
``slu_serve_queue_wait_seconds`` histograms.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import numpy as np
import torch

from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.obs.slo import NULL_TICKET, TicketContext, get_accounter
from superlu_dist_tpu_torch.utils.lockwatch import make_condition, make_lock
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.solve.plan import bucket_nrhs
from superlu_dist_tpu_torch.utils.errors import (
    FactorCorruptError, NumericBreakdownError, ServeDeadlineError,
    ServeOverloadError, ServePoisonedError, ServerClosedError,
    SingularMatrixError, SuperLUError)


def on_device(device):
    """Make ``device`` current for the calling thread (a thread's current
    CUDA device is its own); a no-op for the CPU."""
    dev = torch.device(device)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class _Request:
    """One submitted right-hand side, possibly column-split over several
    micro-batches; completes when every column has been solved."""

    __slots__ = ("b", "k", "squeeze", "remaining", "parts", "error",
                 "t_submit", "t_deadline", "deadline_s", "slow_client_s",
                 "rungs", "event", "ctx")

    def __init__(self, b: np.ndarray, squeeze: bool):
        self.b = b
        self.k = b.shape[1]
        self.squeeze = squeeze
        self.remaining = self.k
        self.parts = []          # [(col offset, solved columns array)]
        self.error = None
        self.ctx = NULL_TICKET   # TicketContext when tracing is on
        self.t_submit = time.perf_counter()
        self.t_deadline = None   # absolute perf_counter expiry, or None
        self.deadline_s = 0.0
        self.slow_client_s = None    # chaos slow_client stall, or None
        self.rungs = []          # per-ticket recovery records (BERR gate)
        self.event = threading.Event()


class SolveTicket:
    """Handle for one submitted request (future-style)."""

    def __init__(self, req: _Request, server: "SolveServer"):
        self._req = req
        self._server = server

    def done(self) -> bool:
        return self._req.event.is_set()

    @property
    def rungs(self) -> list:
        """Per-ticket recovery actions taken for THIS request (e.g. the
        ``serve-ir`` BERR-gate rung) — the SolveReport analog of the
        serving tier."""
        return list(self._req.rungs)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until the request's solve completes and return x with
        the submitted shape ((n,) stays (n,)).  Raises the request's
        structured error if it was shed/expired/poisoned or its batch
        dispatch failed, TimeoutError on expiry of ``timeout``.

        A request with an armed serving deadline is expired HERE too
        when the dispatcher is stalled: the waiter raises
        :class:`ServeDeadlineError` at its deadline instead of hanging
        until ``timeout``."""
        req = self._req
        if req.slow_client_s:        # chaos slow_client: stalled collector
            time.sleep(req.slow_client_s)
        end = None if timeout is None else time.perf_counter() + timeout
        while not req.event.is_set():
            now = time.perf_counter()
            if end is not None and now >= end:
                raise TimeoutError(
                    f"solve request ({req.k} columns) not served "
                    f"within {timeout}s")
            bounds = [] if end is None else [end - now]
            if req.t_deadline is not None:
                if now >= req.t_deadline:
                    # queued past the deadline: expire it ourselves (a
                    # no-op if the dispatcher carved it in-flight — the
                    # result is then imminent, keep polling briefly)
                    if not self._server._expire_request(req, now):
                        bounds = [min(bounds) if bounds else 0.05, 0.05]
                else:
                    bounds.append(req.t_deadline - now)
            req.event.wait(min(bounds) if bounds else None)
        if req.error is not None:
            raise req.error
        parts = sorted(req.parts, key=lambda p: p[0])
        x = (parts[0][1] if len(parts) == 1
             else np.concatenate([p[1] for p in parts], axis=1))
        return x[:, 0] if req.squeeze else x


class SolveServer:
    """Micro-batching solve service over one factored handle.

    Parameters
    ----------
    lu : LUFactorization
        A FACTORED handle (``lu.numeric`` present) — from a live
        ``gssvx`` call or ``persist.load_lu``.  The server serves on its
        device (``lu.device``).
    max_batch : int
        Micro-batch column cap; 0/None reads ``SLU_TPU_SERVE_MAX_BATCH``
        (whose 0 default means: the device solve's nrhs bucket cap).
    max_wait_s : float
        Coalescing window; None reads ``SLU_TPU_SERVE_MAX_WAIT_MS``.
    trans / conj :
        Serve ``AᵀX = B`` (``AᴴX = B``) through the same factors.
    queue_max : int
        Admission cap in pending COLUMNS; None reads
        ``SLU_TPU_SERVE_QUEUE_MAX`` (0 = unbounded).
    deadline_s : float
        Per-request serving deadline; None reads
        ``SLU_TPU_SERVE_DEADLINE_MS`` (0 = off).
    berr_max : float
        Per-request componentwise-berr quality gate; None reads
        ``SLU_TPU_SERVE_BERR_MAX`` (0 = off).  Needs the original
        matrix (``a=`` or a live handle carrying ``lu.a``).
    scrub_s : float
        Factor-integrity scrub period; None reads
        ``SLU_TPU_SERVE_SCRUB_S`` (0 = no background thread;
        :meth:`scrub_now` stays callable).
    a : SparseCSR
        The original matrix, for the BERR gate's residuals (defaults to
        ``lu.a`` — persist-loaded handles carry none).
    start : bool
        Spawn the dispatcher immediately; ``start=False`` lets tests
        enqueue a deterministic backlog first, then :meth:`start`.
    """

    def __init__(self, lu, max_batch: int | None = None,
                 max_wait_s: float | None = None, trans: bool = False,
                 conj: bool = False, start: bool = True,
                 queue_max: int | None = None,
                 deadline_s: float | None = None,
                 berr_max: float | None = None,
                 scrub_s: float | None = None, a=None):
        from superlu_dist_tpu_torch.utils.options import env_float, env_int
        if lu is None or lu.numeric is None:
            raise SuperLUError(
                "SolveServer requires a FACTORED handle (lu.numeric is "
                "None — factor first, or load a persisted bundle via "
                "SolveServer.from_bundle)")
        self.lu = lu
        self.n = int(lu.n)
        self.device = lu.device
        self.trans = bool(trans)
        self.conj = bool(conj)
        self._solve = self._make_solve(lu)
        from superlu_dist_tpu_torch.solve.plan import nrhs_buckets
        buckets = nrhs_buckets(env_int("SLU_TPU_SOLVE_NRHS_MAX"),
                               env_float("SLU_TPU_SOLVE_NRHS_GROWTH"))
        if not max_batch:
            max_batch = env_int("SLU_TPU_SERVE_MAX_BATCH")
        if not max_batch:
            max_batch = buckets[-1]     # the nrhs bucket cap
        self.max_batch = int(max_batch)
        # the batch sizes this server targets: the compiled nrhs buckets
        # up to (and always including) its own cap
        self._bucket_set = tuple(
            b for b in buckets if b < self.max_batch) + (self.max_batch,)
        if max_wait_s is None:
            max_wait_s = env_float("SLU_TPU_SERVE_MAX_WAIT_MS") / 1000.0
        self.max_wait_s = float(max_wait_s)
        # --- reliability knobs ------------------------------------------
        if queue_max is None:
            queue_max = env_int("SLU_TPU_SERVE_QUEUE_MAX")
        self.queue_max = int(queue_max)
        if deadline_s is None:
            deadline_s = env_float("SLU_TPU_SERVE_DEADLINE_MS") / 1000.0
        self.deadline_s = float(deadline_s)
        if berr_max is None:
            berr_max = env_float("SLU_TPU_SERVE_BERR_MAX")
        self._berr_max = float(berr_max)
        if scrub_s is None:
            scrub_s = env_float("SLU_TPU_SERVE_SCRUB_S")
        self.scrub_s = float(scrub_s)
        self._berr_op = None
        if self._berr_max > 0:
            if self.conj:
                raise SuperLUError(
                    "the serve BERR gate does not support conj servers "
                    "(residual needs an Aᴴ SpMV the gate does not build)")
            src = a if a is not None else lu.a
            if src is None:
                raise SuperLUError(
                    "SLU_TPU_SERVE_BERR_MAX needs the original matrix "
                    "for its residuals — pass a=..., or serve a live "
                    "handle that carries lu.a (persist bundles do not)")
            self._berr_op = self._gate_operator(lu, src)
        self.source = "live"
        # instrumented under SLU_TPU_VERIFY_LOCKS=1 (utils/lockwatch):
        # the condition shares the lock's identity — one mutex
        self._lock = make_lock("SolveServer._lock")
        self._cond = make_condition("SolveServer._cond", self._lock)
        # queue of [request, columns-already-taken] — a wide request
        # drains across batches without blocking narrower traffic
        self._queue: collections.deque = collections.deque()
        self._pending_cols = 0
        self._inflight = 0
        self._closed = False
        self._draining = False
        self._flush = False
        self._quarantine = None      # FactorCorruptError once scrub fails
        self._handle_epoch = 0
        self._digests = None         # per-front (sha_l, sha_u) baseline
        self._digest_source = "live handle (construction)"
        self._thread = None
        self._scrub_thread = None
        self._scrub_stop = threading.Event()
        # totals (under _lock); the metrics registry mirrors them when on
        self._requests = 0
        self._columns = 0
        self._batches = 0
        self._batch_cols = 0
        self._errors = 0
        self._shed = 0
        self._deadline_miss = 0
        self._poisoned = 0
        self._refined = 0
        self._swaps = 0
        self._refactors = 0
        self._scrub_runs = 0
        self._scrub_failures = 0
        self._metrics = m = get_metrics()
        self._metrics = m if m.enabled else None
        # latched once (the NULL_TRACER discipline): None when tracing
        # is off so submit pays one `is None` test and mints no context
        t = get_tracer()
        self._tracer = t if t.enabled else None
        self._accounter = get_accounter()    # always-on latency floor
        from superlu_dist_tpu_torch.testing.chaos import get_serve_chaos
        self._chaos = get_serve_chaos()
        if self.scrub_s > 0:
            self._digests = self._compute_digests()
            self._scrub_thread = threading.Thread(
                target=self._on_device_loop, args=(self._scrub_loop,),
                name="slu-serve-scrub",
                daemon=True)
            self._scrub_thread.start()
        if start:
            self.start()

    # ------------------------------------------------------------------
    @classmethod
    def from_bundle(cls, dirpath: str, device=None, **kw) -> "SolveServer":
        """Serve from a persisted LU bundle (persist/serial.save_lu):
        the handle loads digest-verified onto ``device`` (None: the card;
        CUDA without a card raises) and solves with ZERO
        refactorization — the warm-start path a serving fleet restarts
        through (FACT time stays 0.0).  The bundle's manifest digests
        become the scrub baseline — the DURABLE ground truth."""
        from superlu_dist_tpu_torch.persist.serial import (
            bundle_front_digests, load_lu)
        srv = cls(load_lu(dirpath, device=device), **kw)
        srv.source = str(dirpath)
        # the scrubber thread (scrub_s > 0) is already live here: the
        # digest re-base must happen under the lock it scans with; hash
        # outside, assign inside
        digests = bundle_front_digests(dirpath)
        with srv._lock:
            srv._digests = digests
            srv._digest_source = f"bundle {dirpath}"
        return srv

    def _gate_operator(self, lu, a):
        """The operator the BERR gate takes its residuals with: the
        driver's refinement operator (``refine_operator``: on the card a
        ``DeviceSpMV`` through ``csr_spmv`` for a matrix of at least
        ``DEVICE_SPMV_MIN_NNZ`` entries, cached on the handle; else the
        host matrix), of Aᵀ for a trans server."""
        from superlu_dist_tpu_torch.drivers.gssvx import refine_operator
        from superlu_dist_tpu_torch.utils.options import Trans
        trans = Trans.TRANS if self.trans else Trans.NOTRANS
        return refine_operator(lu, a, a.transpose() if self.trans else a,
                               trans, np.float64)

    def _make_solve(self, lu):
        if self.trans:
            return lambda b: lu.solve_factored_trans(b, conj=self.conj)
        return lu.solve_factored

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._on_device_loop, args=(self._dispatch_loop,),
                name="slu-serve-dispatch",
                daemon=True)
            self._thread.start()
        return self

    def _on_device_loop(self, loop):
        """A server thread's body: the handle's device made current for
        this thread first."""
        with on_device(self.device):
            loop()

    def submit(self, b: np.ndarray, parent=None) -> SolveTicket:
        """Enqueue one right-hand side — (n,) or (n, k), original
        labeling — and return its ticket immediately.  Admission control
        runs HERE: a closed server raises :class:`ServerClosedError`, a
        quarantined handle :class:`FactorCorruptError`, a draining or
        over-capacity queue sheds with :class:`ServeOverloadError`.

        ``parent`` is an optional parent trace context (a router-minted
        ``TicketContext`` or an ``obs.slo.parent_ref``): when tracing is
        on, the request's ``request``-category span chain joins the
        parent's trace id.  With all obs knobs unset and no parent, the
        request carries the shared ``NULL_TICKET`` singleton — zero
        per-submit allocation."""
        b = np.asarray(b)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        if b2.ndim != 2 or b2.shape[0] != self.n or b2.shape[1] == 0:
            raise SuperLUError(
                f"rhs shape {b.shape} does not fit an n={self.n} serve "
                "handle (need (n,) or (n, k>0))")
        k = b2.shape[1]
        m = self._metrics
        expired = ()
        try:
            with self._cond:
                if self._closed:
                    raise ServerClosedError("SolveServer is closed")
                if self._quarantine is not None:
                    q = self._quarantine
                    # dump=False: this re-raise of an already-reported
                    # quarantine performs NO postmortem I/O under the lock
                    raise FactorCorruptError(  # slulint: disable=SLU109
                        q.groups, q.source, dump=False)
                now = time.perf_counter()
                expired = self._expire_due_locked(now)
                if self._draining:
                    self._shed += 1
                    if m is not None:
                        m.inc("slu_serve_shed_total", 1.0,
                              reason="draining")
                    raise ServeOverloadError(k, self._pending_cols,
                                             self.queue_max,
                                             reason="draining")
                if self.queue_max > 0 and self._pending_cols + k > \
                        self.queue_max:
                    self._shed += 1
                    if m is not None:
                        m.inc("slu_serve_shed_total", 1.0,
                              reason="queue_full")
                    raise ServeOverloadError(k, self._pending_cols,
                                             self.queue_max)
                if self._chaos is not None:
                    b2 = self._chaos.poison_submit(b2, self._columns)
                req = _Request(b2, squeeze)
                if self.deadline_s > 0:
                    req.deadline_s = self.deadline_s
                    req.t_deadline = req.t_submit + self.deadline_s
                if self._chaos is not None and \
                        self._chaos.is_slow_client(self._requests):
                    req.slow_client_s = self._chaos.plan.secs
                self._queue.append([req, 0])
                self._pending_cols += req.k
                self._requests += 1
                self._columns += req.k
                depth = self._pending_cols
                if self._tracer is not None or (
                        parent is not None
                        and getattr(parent, "enabled", False)):
                    req.ctx = TicketContext(f"s{self._requests}",
                                            req.t_submit, parent)
                    req.ctx.note(nrhs=req.k)
                self._cond.notify_all()
        finally:
            # deadline postmortems (flight dump + span emit) run OUTSIDE
            # the lock: no I/O under it
            self._deadline_postmortems(expired)
        if m is not None:
            m.inc("slu_serve_requests_total", 1.0)
            m.inc("slu_serve_columns_total", float(req.k))
            m.set("slu_serve_queue_depth", float(depth))
        return SolveTicket(req, self)

    def solve(self, b: np.ndarray,
              timeout: float | None = None) -> np.ndarray:
        """submit() + result(): the one-call convenience path."""
        return self.submit(b).result(timeout)

    def flush(self):
        """Dispatch whatever is pending without waiting out the
        coalescing window."""
        with self._cond:
            self._flush = True
            self._cond.notify_all()

    # ------------------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Cooperative drain: reject new work (``ServeOverloadError``,
        reason ``draining``) while finishing everything already queued
        and in-flight.  Returns True once the queue and the in-flight
        batch are empty (False on ``timeout``).  The server stays alive
        — :meth:`swap` then :meth:`resume` is the refactor-on-degrade
        sequence; :meth:`close` the shutdown one."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._cond:
            self._draining = True
            self._flush = True
            self._cond.notify_all()
            while self._queue or self._inflight:
                if self._thread is None or not self._thread.is_alive():
                    # no dispatcher will ever serve these: deliver the
                    # structured shutdown error instead of stranding them
                    self._purge_queue_locked(
                        lambda req: ServerClosedError(
                            "SolveServer drained with no dispatcher — "
                            "request abandoned undelivered"))
                    return True
                left = None if end is None else end - time.perf_counter()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left if left is not None else 0.5)
            return True

    def resume(self):
        """Lift drain mode: accept submissions again."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()
        return self

    def close(self, timeout: float | None = 10.0):
        """Stop accepting work, drain the queue, join the dispatcher —
        then deliver :class:`ServerClosedError` to every ticket still
        undelivered (a never-started or dead dispatcher cannot strand a
        waiter; the satellite fix for the submit/close race).

        The joins are BOUNDED by default: interpreter shutdown must never race a live daemon against
        module teardown, so a wedged dispatcher is abandoned after
        ``timeout`` (its queued tickets still get their structured
        error) instead of hanging ``close()`` forever.  Pass
        ``timeout=None`` to wait indefinitely.

        Racing an in-flight :meth:`swap`: close WINS — a swap that has
        not installed its target by the time close takes the lock
        raises ``ServerClosedError`` and releases the target (see the
        swap docstring; tests/test_serve_robust.py pins the
        ordering)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._scrub_stop.set()
        if self._scrub_thread is not None:
            self._scrub_thread.join(1.0 if timeout is None else
                                    min(1.0, timeout))
            self._scrub_thread = None
        if self._thread is not None:
            self._thread.join(timeout)
        if self._thread is None or not self._thread.is_alive():
            with self._cond:
                self._purge_queue_locked(
                    lambda req: ServerClosedError(
                        "SolveServer closed before this request was "
                        "served"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def swap(self, lu_or_bundle) -> "SolveServer":
        """Atomically replace the factored handle between batches — the
        hot-swap path (refactor-on-degrade, scheduled refresh, or
        recovery from quarantine).  Accepts a live FACTORED
        ``LUFactorization`` or a persist-bundle path.  Queued and future
        requests are served by the new handle; the in-flight batch (if
        any) finishes on the old one — zero tickets dropped.  Clears a
        scrub quarantine and re-bases the scrub digests.

        Ordering contract vs :meth:`close` (the two linearize on the
        server lock): **close wins**.  A ``close()`` that takes the
        lock before the swap installs makes this call raise
        :class:`ServerClosedError` — the swap target is released, never
        installed, and every undelivered ticket gets its deterministic
        ``ServerClosedError`` from ``close()``'s purge.  A swap that
        installs first completes normally and the close then shuts the
        swapped server down the ordinary way.  A bundle loads onto the
        server's device; a live handle must already be there."""
        from superlu_dist_tpu_torch.persist.serial import (
            bundle_front_digests, load_lu)
        source = None
        lu = lu_or_bundle
        if isinstance(lu_or_bundle, (str, os.PathLike)):
            source = str(lu_or_bundle)
            with on_device(self.device):
                lu = load_lu(source, device=self.device)
        if lu is None or lu.numeric is None:
            raise SuperLUError(
                "swap() requires a FACTORED handle (lu.numeric present) "
                "or a persisted bundle path")
        if int(lu.n) != self.n:
            raise SuperLUError(
                f"swap() handle is n={int(lu.n)}, server is n={self.n} "
                "— a swapped handle must factor the same-sized system")
        if lu.device != self.device:
            raise SuperLUError(
                f"swap() handle lives on {lu.device}, the server serves on "
                f"{self.device}")
        solve = self._make_solve(lu)
        # the scrubber thread re-bases self._digests under the lock, so
        # even this presence test must hold it; the digest hashing itself
        # stays OUTSIDE the lock
        with self._lock:
            rebase = self.scrub_s > 0 or self._digests is not None
        digests = None
        if rebase:
            digests = (bundle_front_digests(source) if source is not None
                       else self._compute_digests(lu))
        berr_op = self._berr_op
        if self._berr_max > 0 and lu.a is not None:
            berr_op = self._gate_operator(lu, lu.a)
        with self._cond:
            if self._closed:
                # the close()/swap() ordering contract: close WINS.  The
                # freshly loaded/validated target is released (never
                # installed), and close()'s purge has already delivered
                # ServerClosedError to every undelivered ticket.
                raise ServerClosedError(
                    "swap() aborted: the server closed during the swap "
                    "(close wins — the swap target was released and all "
                    "queued tickets received ServerClosedError)")
            self.lu = lu
            self._solve = solve
            self._handle_epoch += 1
            self._quarantine = None
            self._digests = digests
            self._digest_source = (f"bundle {source}" if source is not None
                                   else "live handle (swap)")
            self._berr_op = berr_op
            if source is not None:
                self.source = source
            self._swaps += 1
            self._cond.notify_all()
        if self._metrics is not None:
            self._metrics.inc("slu_serve_swaps_total", 1.0)
        return self

    # ------------------------------------------------------------------
    def refactor(self, new_values, canary_b=None,
                 berr_max=None) -> "SolveServer":
        """Same-pattern hot refactorization: re-run the numeric phase of
        the SERVED handle over ``new_values`` (a same-pattern SparseCSR,
        or a raw CSR data array in the original matrix's ordering) and
        :meth:`swap` the result in — symbolic, plan, and compiled
        programs all reused, zero tickets dropped.  The pipeline is the
        crash-consistent one from ``drivers.gssvx.refactor``: the shadow
        factorization runs against a COPY of the handle, is BERR-gated
        on a canary solve, and only an adopted shadow reaches the swap —
        a poisoned/singular refactor raises
        :class:`~superlu_dist_tpu_torch.utils.errors.RefactorRollbackError`
        (or :class:`PatternMismatchError` on pattern drift) with the
        previous handle still serving every queued and future ticket.
        On the card the shadow factorization runs the stream executor's
        ``front_assemble`` launches, one per dispatch group."""
        import dataclasses

        from superlu_dist_tpu_torch.drivers.gssvx import refactor as _refactor
        with self._lock:
            if self._closed:
                raise ServerClosedError("SolveServer is closed")
            live = self.lu
        # the shadow handle shares the (immutable) symbolic fact, plan,
        # and compiled executors with the live one; refactor() adopts
        # onto the shadow only, so in-flight batches keep the old panels
        shadow = dataclasses.replace(live)
        with on_device(self.device):
            _refactor(shadow, new_values, canary_b=canary_b,
                      berr_max=0.0 if berr_max is None else berr_max)
        self.swap(shadow)
        with self._lock:
            self._refactors += 1
        if self._metrics is not None:
            self._metrics.inc("slu_serve_refactors_total", 1.0)
        return self

    # ------------------------------------------------------------------
    def _compute_digests(self, lu=None):
        from superlu_dist_tpu_torch.persist.serial import front_digests
        return front_digests((lu or self.lu).numeric.fronts)

    def scrub_now(self) -> list:
        """One factor-integrity scrub pass: re-hash the handle's
        resident panel stacks and compare against the baseline digests
        (persist-bundle manifest for ``from_bundle`` servers,
        construction/swap-time hashes otherwise).  Returns [] when
        clean; on mismatch the handle is QUARANTINED — queued tickets
        get the :class:`FactorCorruptError`, future submits are
        refused until :meth:`swap` — and the error raises (with its
        flight-recorder postmortem already dumped)."""
        with self._lock:
            epoch = self._handle_epoch
            numeric = self.lu.numeric
            base = self._digests
        if self._chaos is not None:
            self._chaos.corrupt_resident_panel(numeric.fronts)
        from superlu_dist_tpu_torch.persist.serial import front_digests
        cur = front_digests(numeric.fronts)
        m = self._metrics
        if base is None:
            # first manual scrub of an unarmed server: establish the
            # baseline (nothing to compare yet)
            with self._cond:
                if epoch == self._handle_epoch:
                    self._digests = cur
                    self._scrub_runs += 1
            if m is not None:
                m.inc("slu_serve_scrub_runs_total", 1.0)
            return []
        bad = [g for g, (c, b) in enumerate(zip(cur, base)) if c != b]
        # construct (and flight-dump) the error OUTSIDE the lock: the
        # postmortem write must not stall submit/dispatch on the server
        # lock.  A swap racing the scrub makes
        # the dump a stale-handle artifact — rare, and still evidence.
        err = (FactorCorruptError(bad, source=self._digest_source)
               if bad else None)
        with self._cond:
            if epoch != self._handle_epoch:
                return []    # swapped mid-scrub: the scan is stale
            self._scrub_runs += 1
            if err is not None:
                self._quarantine = err
                self._scrub_failures += 1
                self._purge_queue_locked(lambda req: err)
                self._cond.notify_all()
        if m is not None:
            m.inc("slu_serve_scrub_runs_total", 1.0)
            if err is not None:
                m.inc("slu_serve_scrub_failures_total", 1.0)
        if err is not None:
            raise err
        return []

    def _scrub_loop(self):
        while not self._scrub_stop.wait(self.scrub_s):
            try:
                self.scrub_now()
            except FactorCorruptError:
                # quarantine installed + postmortem dumped; keep
                # scrubbing — a swap() re-bases the digests and the
                # next pass verifies the fresh handle
                pass
            except Exception:
                pass    # the scrubber must never kill the process

    # ------------------------------------------------------------------
    def idle(self) -> bool:
        """True when nothing is queued or in flight — the fleet handle
        cache's eviction predicate (serve/handlecache.py): only an idle
        server may be evicted, so eviction can never drop a ticket."""
        with self._lock:
            return not self._queue and not self._inflight

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Serving counters so far (process-local; the metrics registry
        carries the scrapeable twin)."""
        with self._lock:
            batches = self._batches
            return {
                "requests": self._requests,
                "columns": self._columns,
                "batches": batches,
                "errors": self._errors,
                "shed": self._shed,
                "deadline_miss": self._deadline_miss,
                "poisoned_columns": self._poisoned,
                "refined": self._refined,
                "swaps": self._swaps,
                "refactors": self._refactors,
                "scrub_runs": self._scrub_runs,
                "scrub_failures": self._scrub_failures,
                "queue_depth": self._pending_cols,
                "mean_batch_columns": (round(self._batch_cols / batches, 2)
                                       if batches else 0.0),
                "max_batch": self.max_batch,
                "max_wait_s": self.max_wait_s,
                "queue_max": self.queue_max,
                "deadline_s": self.deadline_s,
                "source": self.source,
                "closed": self._closed,
                "draining": self._draining,
                "quarantined": self._quarantine is not None,
            }

    # ------------------------------------------------------------------
    def _expire_request(self, req: _Request, now: float) -> bool:
        """Expire one deadline-missed request if it is still queued
        (called from its waiting ticket).  Returns True when the ticket
        was delivered its ServeDeadlineError (or had already been
        delivered something); False when the request is in-flight in a
        batch — the result is imminent and wins."""
        delivered = False
        with self._cond:
            if req.event.is_set():
                return True
            for entry in self._queue:
                if entry[0] is req:
                    self._queue.remove(entry)
                    self._pending_cols -= req.k - entry[1]
                    self._fail_expired_locked(req, now)
                    self._cond.notify_all()
                    delivered = True
                    break
        if delivered:
            self._deadline_postmortems([req])
        return delivered

    def _fail_expired_locked(self, req: _Request, now: float) -> None:
        ctx = req.ctx
        if ctx.enabled:
            # the whole budget went to the queue: one contiguous stage
            ctx.stage("queue_wait", req.t_submit, now - req.t_submit)
            ctx.note(deadline_s=req.deadline_s)
        # constructed under the lock: ServeDeadlineError does NO
        # postmortem I/O at construction — the caller invokes
        # flight_postmortem() outside the lock (_deadline_postmortems)
        req.error = ServeDeadlineError(req.deadline_s,
                                       now - req.t_submit, req.k,
                                       stages=ctx.stages_ms() or None)
        req.error.trace_id = ctx.trace_id
        req.event.set()
        self._deadline_miss += 1
        self._accounter.observe(req.k, now - req.t_submit)
        if self._metrics is not None:
            self._metrics.inc("slu_serve_deadline_miss_total", 1.0)

    def _expire_due_locked(self, now: float) -> list:
        """Under the lock: expire every queued request whose serving
        deadline has passed — expired work never reaches a batch, so a
        backlog of abandoned requests cannot starve live ones.  Returns
        the expired requests; the caller MUST hand them to
        ``_deadline_postmortems`` after releasing the lock."""
        if self.deadline_s <= 0:
            return []
        expired = [e for e in self._queue
                   if e[0].t_deadline is not None
                   and now >= e[0].t_deadline]
        if not expired:
            return []
        for entry in expired:
            req, off = entry
            self._queue.remove(entry)
            self._pending_cols -= req.k - off
            self._fail_expired_locked(req, now)
        self._cond.notify_all()
        return [e[0] for e in expired]

    def _deadline_postmortems(self, reqs) -> None:
        """OUTSIDE the lock: flight-dump each expired request's
        ServeDeadlineError (stage timings attached) and emit its span
        chain so the deadline miss shows up on the Perfetto track."""
        if not reqs:
            return
        tracer = None
        for req in reqs:
            err = req.error
            if isinstance(err, ServeDeadlineError):
                err.flight_postmortem()
            ctx = req.ctx
            if ctx.enabled:
                if tracer is None:
                    tracer = get_tracer()
                ctx.emit(tracer, req.t_submit + getattr(
                    err, "waited_s", 0.0), status="deadline_miss")

    def _earliest_deadline_locked(self):
        due = [e[0].t_deadline for e in self._queue
               if e[0].t_deadline is not None]
        return min(due) if due else None

    def _purge_queue_locked(self, err_for) -> int:
        """Under the lock: deliver ``err_for(req)`` to every queued,
        undelivered ticket and empty the queue.  The shutdown /
        quarantine path — a ticket must always resolve to a result or a
        structured error, never a hang."""
        n = 0
        while self._queue:
            req, off = self._queue.popleft()
            self._pending_cols -= req.k - off
            if not req.event.is_set():
                req.error = err_for(req)
                req.event.set()
                n += 1
        self._pending_cols = max(self._pending_cols, 0)
        return n

    # ------------------------------------------------------------------
    def _take_batch(self):
        """Under the lock: carve up to max_batch columns off the queue
        head.  Returns [(request, req_lo, req_hi), ...] (empty on
        shutdown with a drained queue).  Requests already delivered an
        error (expired, poisoned in an earlier batch) are dropped."""
        segs = []
        total = 0
        while self._queue and total < self.max_batch:
            entry = self._queue[0]
            req, off = entry
            if req.event.is_set():       # expired/errored: nothing to do
                self._queue.popleft()
                self._pending_cols -= req.k - off
                continue
            take = min(req.k - off, self.max_batch - total)
            segs.append((req, off, off + take))
            total += take
            if off + take == req.k:
                self._queue.popleft()
            else:
                entry[1] = off + take
        self._pending_cols -= total
        return segs

    def _dispatch_loop(self):
        tracer = get_tracer()
        while True:
            expired = []
            with self._cond:
                while True:
                    now = time.perf_counter()
                    expired += self._expire_due_locked(now)
                    if self._quarantine is not None and self._queue:
                        q = self._quarantine
                        self._purge_queue_locked(
                            lambda req: FactorCorruptError(
                                q.groups, q.source, dump=False))
                    if self._queue:
                        break
                    if self._closed:
                        # exit via the empty-batch path below so the
                        # expired postmortems run OUTSIDE the lock
                        break
                    due = self._earliest_deadline_locked()
                    self._flush = False
                    self._cond.wait(None if due is None
                                    else max(due - now, 0.0))
                # coalescing: hold the oldest request open for the
                # batching window unless the batch can already fill (or
                # a flush/close/drain asked for immediacy).  t_co0 marks
                # the window's start — the queue_wait/coalesce stage
                # boundary for the requests this batch carves.
                t_co0 = time.perf_counter()
                deadline = t_co0 + self.max_wait_s
                while (self._pending_cols < self.max_batch
                       and not self._closed and not self._flush
                       and not self._draining
                       and self._quarantine is None):
                    now = time.perf_counter()
                    expired += self._expire_due_locked(now)
                    if not self._queue:
                        break
                    left = deadline - now
                    due = self._earliest_deadline_locked()
                    if due is not None:
                        left = min(left, due - now)
                    if left <= 0:
                        break
                    self._cond.wait(left)
                self._flush = False
                now = time.perf_counter()
                expired += self._expire_due_locked(now)
                segs = self._take_batch()
                depth = self._pending_cols
                solve_fn = self._solve    # swap-safe snapshot
                self._inflight = sum(hi - lo for _, lo, hi in segs)
            self._deadline_postmortems(expired)
            if not segs:
                with self._cond:
                    self._cond.notify_all()    # wake drain waiters
                    if self._closed and not self._queue:
                        return
                continue
            try:
                self._dispatch(segs, depth, tracer, solve_fn, t_co0)
            except Exception as e:     # noqa: BLE001 — the dispatcher
                for req, lo, hi in segs:       # must never die holding
                    if not req.event.is_set():  # undelivered tickets
                        req.error = e
                        req.event.set()
            finally:
                with self._cond:
                    self._inflight = 0
                    self._cond.notify_all()

    # ------------------------------------------------------------------
    def _bisect_bad(self, mat, solve_fn, lo, hi):
        """Find the poisoned columns of a batch whose WHOLE solve raised
        a numeric breakdown: bisect the column range until each failure
        is pinned to single columns (log₂(width) extra solves, only on
        the failure path)."""
        try:
            x = np.asarray(solve_fn(mat[:, lo:hi]))
        except (NumericBreakdownError, FloatingPointError):
            if hi - lo == 1:
                return [lo]
            mid = (lo + hi) // 2
            return (self._bisect_bad(mat, solve_fn, lo, mid)
                    + self._bisect_bad(mat, solve_fn, mid, hi))
        if x.ndim == 1:
            x = x[:, None]
        fin = np.isfinite(x).all(axis=0)
        return [lo + int(j) for j in np.nonzero(~fin)[0]]

    def _isolate(self, mat, solve_fn, exc):
        """A batch-level numeric failure: localize the offending columns
        and re-serve the healthy ones AT THE ORIGINAL BATCH WIDTH (the
        poisoned columns zeroed — benign), so the survivors' X is
        bit-identical to an unpoisoned dispatch of the same batch
        (per-column independence of the batched sweeps).  Returns
        (x, bad_column_indices); re-raises ``exc`` when the failure
        cannot be localized to columns."""
        bad = self._bisect_bad(mat, solve_fn, 0, mat.shape[1])
        if not bad:
            raise exc
        clean = np.array(mat, copy=True)
        clean[:, bad] = 0
        x = np.asarray(solve_fn(clean))
        fin = np.isfinite(x).all(axis=0)
        more = [int(j) for j in np.nonzero(~fin)[0] if j not in bad]
        if more:
            # columns that only break in the full-width dispatch: fold
            # them into the poisoned set and re-serve once more
            bad = sorted(set(bad) | set(more))
            clean[:, more] = 0
            x = np.asarray(solve_fn(clean))
            if not np.isfinite(np.delete(x, bad, axis=1)).all():
                raise exc       # not column-local after all
        return x, bad

    def _berr_gate(self, req, solve_fn):
        """Per-ticket residual quality gate (``SLU_TPU_SERVE_BERR_MAX``):
        a completing request whose componentwise berr exceeds the gate
        is routed through the per-ticket IR rung — its neighbors in the
        micro-batch are untouched."""
        from superlu_dist_tpu_torch.refine.ir import refine_ticket
        parts = sorted(req.parts, key=lambda p: p[0])
        x = (parts[0][1] if len(parts) == 1
             else np.concatenate([p[1] for p in parts], axis=1))
        x2, before, after, adopted = refine_ticket(
            self._berr_op, req.b, x, solve_fn, self._berr_max)
        if before <= self._berr_max:
            return
        if adopted:
            req.parts = [(0, np.asarray(x2))]
        req.rungs.append({"rung": "serve-ir", "berr_before": before,
                          "berr_after": after, "adopted": adopted,
                          "target": self._berr_max})
        with self._lock:
            self._refined += 1
        if self._metrics is not None:
            self._metrics.inc("slu_serve_refined_total", 1.0)

    def _stage_prefix(self, ctx, req, t_co0, t0, td0, td1):
        """Record the shared stage prefix of a completing/poisoned
        request: queue_wait → coalesce → dispatch → device, contiguous
        from submit to the device-solve end (each stage starts where
        the previous one ended, so durations sum exactly)."""
        tc = min(max(t_co0, req.t_submit), t0)
        ctx.stage("queue_wait", req.t_submit, tc - req.t_submit)
        ctx.stage("coalesce", tc, t0 - tc)
        ctx.stage("dispatch", t0, td0 - t0)
        ctx.stage("device", td0, td1 - td0)

    def _dispatch(self, segs, depth, tracer, solve_fn, t_co0=None):
        cols = sum(hi - lo for _, lo, hi in segs)
        kb = bucket_nrhs(min(cols, self.max_batch), self._bucket_set)
        t0 = time.perf_counter()
        if t_co0 is None:
            t_co0 = t0
        m = self._metrics
        if m is not None:
            for req, lo, hi in segs:
                m.observe("slu_serve_queue_wait_seconds",
                          t0 - req.t_submit)
        if len(segs) == 1:
            req, lo, hi = segs[0]
            mat = req.b[:, lo:hi]
        else:
            dtype = np.result_type(*(s[0].b.dtype for s in segs))
            mat = np.empty((self.n, cols), dtype=dtype)
            c = 0
            for req, lo, hi in segs:
                mat[:, c:c + hi - lo] = req.b[:, lo:hi]
                c += hi - lo
        x, err, bad = None, None, ()
        td0 = time.perf_counter()      # dispatch/device stage boundary
        try:
            with tracer.span("serve-batch", cat="dispatch", columns=cols,
                             bucket=kb, requests=len(segs),
                             queue_depth=depth, trans=self.trans):
                x = np.asarray(solve_fn(mat))
            if not np.isfinite(x).all():
                # poisoned request(s): the healthy columns of THIS
                # result are already bit-exact (per-column independence)
                # — only the non-finite ones fail
                bad = [int(j) for j in
                       np.nonzero(~np.isfinite(x).all(axis=0))[0]]
        except NumericBreakdownError as e:
            try:
                x, bad = self._isolate(mat, solve_fn, e)
            except Exception as e2:     # noqa: BLE001
                x, err = None, e2
        except Exception as e:          # noqa: BLE001 — the error belongs
            x, err = None, e            # to the tickets, not the loop
        now = time.perf_counter()
        done_lat = []
        acct = self._accounter
        with self._lock:
            self._batches += 1
            self._batch_cols += cols
            if err is not None:
                self._errors += 1
            if bad:
                self._poisoned += len(bad)
        c = 0
        for req, lo, hi in segs:
            w = hi - lo
            if req.event.is_set():      # expired while in flight
                c += w
                continue
            ctx = req.ctx
            seg_bad = [j for j in bad if c <= j < c + w]
            if err is not None:
                req.error = err
                req.event.set()
            elif seg_bad:
                if ctx.enabled:
                    self._stage_prefix(ctx, req, t_co0, t0, td0, now)
                # constructed OUTSIDE the server lock: the flight dump
                # at construction carries the stage timings
                req.error = ServePoisonedError(
                    [lo + (j - c) for j in seg_bad], batch_columns=cols,
                    where="serve-batch",
                    stages=ctx.stages_ms() or None)
                req.error.trace_id = ctx.trace_id
                if ctx.enabled:
                    ctx.emit(tracer, now, status="poisoned")
                req.event.set()
            else:
                req.parts.append((lo, x[:, c:c + w]))
                req.remaining -= w
                if req.remaining == 0:
                    tref = now
                    if self._berr_max > 0:
                        self._berr_gate(req, solve_fn)
                        tref = time.perf_counter()
                    t_end = time.perf_counter()
                    lat = t_end - req.t_submit
                    if ctx.enabled:
                        self._stage_prefix(ctx, req, t_co0, t0, td0, now)
                        ctx.stage("refine", now, tref - now)
                        ctx.stage("deliver", tref, t_end - tref)
                        ctx.note(bucket=kb, batch_columns=cols,
                                 queue_depth=depth)
                        ctx.emit(tracer, t_end)
                    done_lat.append(lat)
                    acct.observe(req.k, lat)
                    req.event.set()
            c += w
        if m is not None:
            m.inc("slu_serve_batches_total", 1.0)
            m.set("slu_serve_queue_depth", float(depth))
            m.observe("slu_serve_batch_fill", cols / max(kb, 1))
            m.set("slu_serve_batch_seconds", now - t0)
            if err is not None:
                m.inc("slu_serve_errors_total", 1.0,
                      error=type(err).__name__)
            if bad:
                m.inc("slu_serve_poisoned_total", float(len(bad)))
            for lat in done_lat:
                m.observe("slu_serve_request_seconds", lat)
