"""Error model.

The reference reports errors via ``info`` codes (<0: the -info-th argument
was invalid, via pxerr_dist; >0: U(i,i) is exactly singular, pdgstrf.c:234-241)
or aborts (ABORT, util_dist.h:27-34).  We use exceptions for argument errors
and return ``info`` from drivers for singularity, matching pdgssvx semantics.
The error classes that carry evidence dump the flight recorder
(obs/flightrec.py) at construction, as the JAX package's do.
"""


def _flight_dump(exc) -> None:
    """Flight-recorder postmortem hook (obs/flightrec.py): the
    structured breakdown/serving errors dump the telemetry ring at
    CONSTRUCTION time, so the evidence lands on disk even when the
    exception later dies inside a worker process or an over-broad caller
    ``except``.  Must never interfere with raising the error itself."""
    try:
        from superlu_dist_tpu_torch.obs.flightrec import on_error
        exc.flightrec_dump = on_error(exc)   # path, or None when off
    except Exception:
        exc.flightrec_dump = None


class SuperLUError(Exception):
    """Invalid argument / internal error (analog of pxerr_dist + ABORT)."""


class SingularMatrixError(SuperLUError):
    """U(i,i) exactly singular and ReplaceTinyPivot disabled (info > 0)."""

    def __init__(self, k: int):
        self.info = k + 1   # reference convention: 1-based first zero pivot
        super().__init__(f"Factorization failed: U({k},{k}) is exactly zero "
                         f"(info={self.info})")


class NumericBreakdownError(SuperLUError):
    """A non-finite value (NaN/Inf) appeared in the computed factors or the
    solution while ReplaceTinyPivot was active — overflow or NaN input, not
    plain singularity (which SingularMatrixError covers).  Tripped by the
    isfinite sentinels in the numeric layer so a breakdown surfaces at the
    offending supernode (the structured replacement for the reference's
    ABORT, util_dist.h:27-34)."""

    def __init__(self, supernode: int = -1, col: int = -1, where: str = ""):
        self.supernode = int(supernode)   # first contaminated supernode
        self.col = int(col)               # its first global column (0-based)
        self.where = where                # which stage tripped the sentinel
        loc = (f" at supernode {supernode} (column {col})"
               if supernode >= 0 else "")
        stage = f" during {where}" if where else ""
        super().__init__(
            f"non-finite values detected{stage}{loc}; the system is "
            "numerically broken down (overflow or NaN input)")
        _flight_dump(self)


class PatternMismatchError(SuperLUError):
    """A values-only refactorization (``drivers/gssvx.refactor``) was handed
    a matrix whose sparsity pattern or shape differs from the one the
    handle's symbolic structure was built on.  Re-running the symbolic
    phase silently would break the refactor contract (no symbolic work,
    the plan reused), so drift is a typed error: re-analyze with
    ``Fact=DOFACT`` to factor the new pattern.  ``expected_digest`` and
    ``got_digest`` are the sha256 pattern digests
    (``persist/serial.pattern_digest``) where both sides could compute one."""

    def __init__(self, reason: str, expected_digest: str = "",
                 got_digest: str = "", n: int = -1, nnz: int = -1):
        self.reason = reason
        self.expected_digest = expected_digest
        self.got_digest = got_digest
        self.n = int(n)
        self.nnz = int(nnz)
        dg = (f" (handle pattern {expected_digest[:12]}, "
              f"got {got_digest[:12]})"
              if expected_digest and got_digest else "")
        super().__init__(
            f"refactor refused: {reason}{dg} — a values-only refactor "
            "requires the exact sparsity pattern the handle was analyzed "
            "on; factor the new pattern with Fact=DOFACT instead")
        _flight_dump(self)


class RefactorRollbackError(SuperLUError):
    """A refactorization was rolled back: the shadow factorization of the
    new values broke down (NaN/Inf, singular) or missed its BERR canary
    gate, so the handle keeps its previous factors.  ``stage`` names the
    failing check (``factor`` / ``canary``), ``replica`` is -1 for the
    handle-level refactor (the JAX package's fleet verb, which is not
    ported, rolls replicas back: ``rolled_back``), ``berr`` /
    ``berr_target`` the measured and required canary backward error when
    the gate fired."""

    def __init__(self, key, stage: str, replica: int = -1,
                 rolled_back=(), cause: str = "", berr: float = -1.0,
                 berr_target: float = -1.0):
        self.key = key
        self.stage = stage
        self.replica = int(replica)
        self.rolled_back = sorted(int(r) for r in rolled_back)
        self.cause = cause
        self.berr = float(berr)
        self.berr_target = float(berr_target)
        at = f" on replica {replica}" if replica >= 0 else ""
        why = f": {cause}" if cause else ""
        gate = (f" (berr {berr:.3e} > gate {berr_target:.3e})"
                if berr >= 0.0 and berr_target >= 0.0 else "")
        back = (f"; replica(s) {self.rolled_back} restored to the "
                "previous factors" if self.rolled_back else "")
        super().__init__(
            f"refactor of handle {key!r} rolled back at the {stage} "
            f"check{at}{why}{gate}{back} — the previous consistent "
            "factorization keeps serving")
        _flight_dump(self)


class DeadlineExceededError(SuperLUError):
    """The cooperative deadline (``Options.deadline_s``) expired between
    dispatch groups.  The factor loop writes a checkpoint of the
    completed-group frontier first (when checkpointing is armed), so the
    work done before cancellation is durable — ``checkpoint_path`` names it
    and ``gssvx(resume_from=...)`` restarts from it.  ``expired_ranks`` is
    0 for the single-process check, and with a collective deadline the
    number of ranks whose clocks ran out."""

    def __init__(self, deadline_s: float, elapsed_s: float, where: str = "",
                 checkpoint_path: str | None = None,
                 expired_ranks: int = 0):
        self.deadline_s = float(deadline_s)
        self.elapsed_s = float(elapsed_s)
        self.where = where
        self.checkpoint_path = checkpoint_path
        self.expired_ranks = int(expired_ranks)
        stage = f" during {where}" if where else ""
        ck = (f"; frontier checkpointed at {checkpoint_path}"
              if checkpoint_path else "")
        ranks = (f" ({expired_ranks} rank(s) over budget)"
                 if expired_ranks else "")
        super().__init__(
            f"cooperative deadline of {deadline_s:.3f}s exceeded"
            f"{stage} after {elapsed_s:.3f}s{ranks}{ck}")
        _flight_dump(self)


class CheckpointError(SuperLUError):
    """A persisted bundle (LU handle or factor checkpoint) is unusable:
    missing manifest, structural mismatch, or an unreadable artifact.
    Subclasses distinguish the failure families so callers can decide
    between 'refactor from scratch' and 'operator error'."""


class CheckpointCorruptError(CheckpointError):
    """Integrity failure: a per-array digest mismatch or a truncated
    array file.  Raised instead of returning garbage factors — the
    whole point of the manifest (persist/serial.py)."""


class CheckpointVersionError(CheckpointError):
    """The bundle's format version is not one this build can read
    (persist.FORMAT_VERSION)."""


class CheckpointMismatchError(CheckpointError):
    """The checkpoint is internally consistent but belongs to a
    DIFFERENT factorization — plan fingerprint, value digest, dtype,
    threshold or GEMM tier differ from the run trying to resume — or the
    bundle was written by another package whose structures this one does
    not load.  Resuming would silently splice incompatible frontiers, so
    this is a hard error."""


class ServerClosedError(SuperLUError):
    """A ``SolveServer`` request could not be served because the server
    closed: either ``submit()`` was called after ``close()`` (the request
    was never enqueued), or the request was still queued/undelivered when
    the server shut down — ``close()`` delivers this to every undelivered
    ticket deterministically, so a waiter can never hang on a server that
    no longer exists (serve/server.py)."""


class ServeOverloadError(SuperLUError):
    """Admission control shed this request: accepting its columns would
    push the pending queue past ``SLU_TPU_SERVE_QUEUE_MAX``, or the
    server is in drain mode and rejects new work.  Raised AT SUBMIT —
    the request never queues, so an overload degrades into fast
    structured rejections instead of an unbounded queue whose every
    entry eventually misses its deadline.  Retry with backoff, route to
    another replica, or widen the cap."""

    def __init__(self, columns: int, pending_cols: int, queue_max: int,
                 reason: str = "queue_full"):
        self.columns = int(columns)
        self.pending_cols = int(pending_cols)
        self.queue_max = int(queue_max)
        self.reason = reason
        why = ("server is draining (finishing in-flight work, rejecting "
               "new requests)" if reason == "draining" else
               f"queue holds {pending_cols} columns of a "
               f"{queue_max}-column cap")
        super().__init__(
            f"solve request ({columns} column(s)) shed by admission "
            f"control: {why}")


class ServeDeadlineError(SuperLUError):
    """The request's serving deadline (``SLU_TPU_SERVE_DEADLINE_MS``)
    expired while its columns were still queued — the dispatcher (or the
    waiting ticket itself, when the dispatcher is stalled) expired it
    instead of serving an answer the caller has already abandoned.
    Expired work is removed from the queue, so a backlog of dead
    requests cannot starve live ones.

    ``stages`` carries the ticket's per-stage timings (TicketContext
    ``stages_ms()``, obs/slo.py) when request tracing is on, so the
    flight-recorder postmortem names the stage that ate the budget.
    The error is constructed UNDER server locks (the expiry paths), so
    it performs no postmortem I/O at construction — callers invoke
    :meth:`flight_postmortem` once outside the locks (no I/O under a
    lock)."""

    def __init__(self, deadline_s: float, waited_s: float, columns: int,
                 stages: dict | None = None):
        self.deadline_s = float(deadline_s)
        self.waited_s = float(waited_s)
        self.columns = int(columns)
        self.ticket_stages = dict(stages) if stages else None
        self.flightrec_dump = None
        super().__init__(
            f"solve request ({columns} column(s)) missed its "
            f"{deadline_s:.3f}s serving deadline after {waited_s:.3f}s "
            "in queue (shed, not served)")

    def flight_postmortem(self):
        """Dump the flight-recorder postmortem (with the ticket's stage
        timings attached) — call OUTSIDE any server/router lock."""
        _flight_dump(self)
        return self.flightrec_dump


class ServePoisonedError(SuperLUError):
    """THIS request poisoned (or was poisoned inside) a serving
    micro-batch: its column(s) produced non-finite results, or the batch
    solve raised ``NumericBreakdownError`` and bisection pinned the
    blame on them.  The healthy neighbors of the same micro-batch were
    isolated and served bit-identically to an unpoisoned run — one bad
    right-hand side costs only its own ticket (serve/server.py,
    ``_isolate``).  ``columns`` are request-relative 0-based column
    indices.  Dumps a flight-recorder postmortem at construction (the
    poison scatter path constructs it outside the server lock);
    ``stages`` attaches the ticket's per-stage timings (TicketContext
    ``stages_ms()``, obs/slo.py) so the postmortem carries the span
    chain."""

    def __init__(self, columns, batch_columns: int = 0, where: str = "",
                 stages: dict | None = None):
        self.columns = sorted(int(c) for c in columns)
        self.batch_columns = int(batch_columns)
        self.where = where
        self.ticket_stages = dict(stages) if stages else None
        stage = f" during {where}" if where else ""
        batch = (f" of a {batch_columns}-column micro-batch"
                 if batch_columns else "")
        super().__init__(
            f"request column(s) {','.join(map(str, self.columns))} "
            f"poisoned the solve{stage}{batch}: non-finite results "
            "isolated to this ticket (healthy neighbors were re-served "
            "unaffected)")
        _flight_dump(self)


class FactorCorruptError(SuperLUError):
    """The factor-integrity scrubber (``SLU_TPU_SERVE_SCRUB_S``)
    re-hashed the handle's resident panel stacks and found front
    group(s) whose sha256 digest no longer matches the persist-bundle
    (or construction-time) ground truth — silent data corruption in the
    factors.  The handle is QUARANTINED: every queued and future request
    fails with this error instead of being served garbage X, until
    ``server.swap()`` installs a fresh handle.  Dumps a flight-recorder
    postmortem at construction (``dump=False`` for the per-submit
    re-raises of an already-reported quarantine)."""

    def __init__(self, groups, source: str = "", dump: bool = True):
        self.groups = sorted(int(g) for g in groups)
        self.source = source
        src = f" (digest baseline: {source})" if source else ""
        super().__init__(
            f"factor integrity scrub failed: front group(s) "
            f"{','.join(map(str, self.groups))} no longer match their "
            f"sha256 digests{src} — handle quarantined; swap in a fresh "
            "factorization (server.swap) instead of serving corrupt X")
        if dump:
            _flight_dump(self)
        else:
            self.flightrec_dump = None


class ReplicaFailureError(SuperLUError):
    """The fleet router (serve/fleet.py) declared a serving replica
    FAILED: its process died (``pid_alive`` — kill(pid,0) + the
    zombie check), its worker crashed, or a factor-integrity
    quarantine made it unroutable.  Every ticket the replica had
    accepted but not yet delivered is RE-ROUTED to a healthy replica
    under the same idempotent retry token, so a client observes
    bitwise-identical X, never this error — unless zero healthy
    replicas remain, in which case the undelivered tickets are handed
    this error instead of a hang (the zero-loss failover contract).  Dumps a flight-recorder postmortem
    at construction naming the dead replica and the re-routed ticket
    set."""

    def __init__(self, replica: int, tickets, cause: str = "",
                 pid: int = -1, kind: str = "replica"):
        self.replica = int(replica)
        self.tickets = sorted(int(t) for t in tickets)
        self.cause = cause
        self.pid = int(pid)
        self.kind = kind
        why = f" ({cause})" if cause else ""
        who = f" pid {pid}" if pid > 0 else ""
        super().__init__(
            f"fleet {kind} {replica}{who} declared failed{why}; "
            f"{len(self.tickets)} undelivered ticket(s) "
            f"{self.tickets} re-routed to healthy replicas under their "
            "idempotent retry tokens (zero-loss failover — clients see "
            "identical X, not this error, while healthy replicas "
            "remain)")
        _flight_dump(self)


class DeployRollbackError(SuperLUError):
    """A rolling deploy (``FleetRouter.deploy``) was ROLLED BACK: the
    new bundle failed its load/scrub integrity verification or a canary
    batch's quality gate (non-finite X, or componentwise berr past the
    gate) on some replica, so every replica already swapped was
    restored to the previous bundle and the fleet keeps serving the old
    factors.  ``stage`` names the failing check (``load`` / ``scrub`` /
    ``canary``), ``replica`` the replica it failed on, ``rolled_back``
    the replicas that were restored.  Dumps a flight-recorder
    postmortem at construction."""

    def __init__(self, key, bundle: str, stage: str, replica: int = -1,
                 rolled_back=(), cause: str = ""):
        self.key = key
        self.bundle = str(bundle)
        self.stage = stage
        self.replica = int(replica)
        self.rolled_back = sorted(int(r) for r in rolled_back)
        self.cause = cause
        at = f" on replica {replica}" if replica >= 0 else ""
        why = f": {cause}" if cause else ""
        back = (f"; replica(s) {self.rolled_back} restored to the "
                "previous bundle" if self.rolled_back else
                "; no replica had swapped yet")
        super().__init__(
            f"rolling deploy of bundle {self.bundle!r} for handle "
            f"{key!r} rolled back at the {stage} check{at}{why}{back} "
            "— the fleet keeps serving the previous factors "
            "(docs/SERVING.md fleet chapter)")
        _flight_dump(self)


class LockOrderError(SuperLUError):
    """Lock-verify mode (``SLU_TPU_VERIFY_LOCKS=1``,
    ``utils/lockwatch.py``) detected a lock-order
    inversion: this thread is about to acquire ``inner`` while holding
    ``outer``, but the global order graph already records ``inner`` held
    while ``outer`` was acquired (at ``inverse_site``).  Two threads
    entering that cycle from different ends freeze forever; with
    verification on, the acquisition raises HERE — before blocking —
    naming both acquisition sites.  Dumps a flight-recorder
    postmortem at construction."""

    def __init__(self, outer: str, inner: str, site: str,
                 inverse_site: str):
        self.outer = outer
        self.inner = inner
        self.site = site
        self.inverse_site = inverse_site
        super().__init__(
            f"lock-order inversion (SLU109 runtime): acquiring "
            f"`{inner}` while holding `{outer}` at {site}, but the "
            f"inverse order `{inner}` -> `{outer}` was recorded at "
            f"{inverse_site} — two threads entering this cycle from "
            "different ends deadlock (this acquisition raised instead "
            "of blocking; SLU_TPU_VERIFY_LOCKS=1)")
        _flight_dump(self)


class CommTimeoutError(SuperLUError):
    """A bounded-wait collective leg (``SLU_TPU_COMM_TIMEOUT_S``) kept
    timing out on a peer whose process is still ALIVE, and the retry
    budget (``SLU_TPU_COMM_RETRIES`` > 0) ran out.  This is the
    slow-not-dead verdict: the failure detector refused to declare the
    peer failed (its pid answers ``kill(pid, 0)``), so the caller gets a
    timeout, not a :class:`RankFailureError` — retrying later, raising
    the timeout, or widening the budget are all sound.  With the default
    unlimited retries (``SLU_TPU_COMM_RETRIES=0``) this error never
    fires: live-but-slow peers are waited out indefinitely."""

    def __init__(self, op: str, stuck_rank: int, timeout_s: float,
                 retries: int, seq: int = -1, site: str = ""):
        self.op = op
        self.stuck_rank = int(stuck_rank)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.seq = int(seq)
        self.site = site
        where = f" at {site}" if site else ""
        super().__init__(
            f"collective {op} (seq {seq}){where} timed out {retries}x "
            f"({timeout_s:.3f}s each) waiting on live rank {stuck_rank} "
            "— peer is slow, not dead (SLU_TPU_COMM_RETRIES exhausted)")
        _flight_dump(self)


class RankFailureError(SuperLUError):
    """The failure detector declared peer rank(s) DEAD: a bounded-wait
    collective leg timed out (``SLU_TPU_COMM_TIMEOUT_S``), the detector
    found the stuck peer's pid gone (``kill(pid, 0)`` → ESRCH — liveness
    is polled on the process itself, so death is detected even when the
    heartbeat thread died with it), and the survivors converged on the
    same dead set through the ``.ftx`` agreement board (a wait-free
    bulletin domain that excludes the dead rank by construction — no
    survivor ever blocks on it).  Every surviving rank raises this error
    naming the dead rank(s), the op it was inside, the collective
    sequence number and the call site — the ULFM revoke→agree shape: a
    dead rank is a structured, recoverable event, not a fleet-killing
    hang (``Options.ft`` = "shrink"/"respawn" in parallel/recover.py
    resumes the solve on the survivors from the last checkpoint
    frontier)."""

    def __init__(self, dead_ranks, op: str = "", seq: int = -1,
                 site: str = "", rank: int = -1, n_ranks: int = 0,
                 epoch: int = 0):
        self.dead_ranks = sorted(int(r) for r in dead_ranks)
        self.op = op
        self.seq = int(seq)
        self.site = site
        self.rank = int(rank)
        self.n_ranks = int(n_ranks)
        self.epoch = int(epoch)
        where = f" at {site}" if site else ""
        inside = f" during {op} (seq {seq})" if op else ""
        super().__init__(
            f"rank(s) {','.join(map(str, self.dead_ranks))} of "
            f"{n_ranks} declared dead{inside}{where} (epoch {epoch}, "
            f"observed from rank {rank}); survivors agreed via the .ftx "
            "board — recover with Options.ft='shrink'/'respawn' or treat "
            "as fatal (ft='abort')")
        _flight_dump(self)


class CollectiveMismatchError(SuperLUError):
    """Lockstep-verify mode (SLU_TPU_VERIFY_COLLECTIVES=1, the run-time
    form of the JAX package's lint rule SLU106) detected ranks entering DIFFERENT collectives:
    the digest exchange that precedes every TreeComm collective came back
    with divergent (call-site, op, payload shape/dtype, sequence) records.
    Without verification this is the classic silent distributed deadlock —
    each rank blocks forever inside a collective its peers never entered;
    with it, every rank raises this error naming the divergent call sites
    (the MUST-style conversion of a hang into a diagnosis).

    ``records`` holds one dict per rank: {rank, seq, op, shape, dtype,
    root, site}."""

    def __init__(self, records, rank: int = -1):
        self.records = list(records)
        self.rank = int(rank)
        by_site = {}
        for r in self.records:
            key = (r.get("site", "?"), r.get("op", "?"),
                   tuple(r.get("shape", ())), str(r.get("dtype", "?")))
            by_site.setdefault(key, []).append(r.get("rank"))
        parts = []
        for (site, op, shape, dtype), ranks in sorted(by_site.items()):
            rs = ",".join(str(x) for x in ranks)
            parts.append(f"rank(s) {rs}: {op}{list(shape)}:{dtype} "
                         f"at {site}")
        super().__init__(
            "collective lockstep mismatch (SLU106): ranks entered "
            "divergent collectives — " + "; ".join(parts)
            + " — every rank must reach the same TreeComm collective "
              "sequence (this would have deadlocked without "
              "SLU_TPU_VERIFY_COLLECTIVES)")
        _flight_dump(self)
