"""Error model.

The reference reports errors via ``info`` codes (<0: the -info-th argument
was invalid, via pxerr_dist; >0: U(i,i) is exactly singular, pdgstrf.c:234-241)
or aborts (ABORT, util_dist.h:27-34).  We use exceptions for argument errors
and return ``info`` from drivers for singularity, matching pdgssvx semantics.
"""


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


class DeadlineExceededError(SuperLUError):
    """The cooperative deadline (``Options.deadline_s``) expired between
    dispatch groups.  The factor loop writes a checkpoint of the
    completed-group frontier first (when checkpointing is armed), so the
    work done before cancellation is durable — ``checkpoint_path`` names it
    and ``gssvx(resume_from=...)`` restarts from it.  ``expired_ranks`` is
    0 for the single-process check (the multi-rank decision is not
    ported)."""

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
