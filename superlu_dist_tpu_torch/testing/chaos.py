"""Failure-domain chaos harness — deterministic whole-domain injection.

Port of the JAX package's ``testing/chaos.py``: the failure domains a
serving fleet actually loses — a process killed mid-factorization, a
numeric value going NaN at a chosen supernode, a checkpoint artifact
corrupted on disk, a poisoned request, a corrupted resident panel, a
replica killed, quarantined or slowed, a refactor killed or poisoned.
Every injection is a deterministic function of the spec — no randomness
races — so a chaos test either reproduces exactly or the code under test
changed.  The rank-failure specs (``kill_rank``, ``kill_op``,
``stall_rank``) are consumed by ``parallel/treecomm.TreeComm``, which
binds each process's rank (:func:`bind_rank`) and calls
:meth:`ChaosMonkey.on_collective` at every public collective;
:class:`DyingTreeComm` is a rank that dies mid-protocol.

Enable in a victim process via the registered env knob::

    SLU_TPU_CHAOS='kill_group=5'            # SIGKILL self after group 5
    SLU_TPU_CHAOS='kill_group=5,signal=term'  # SIGTERM instead (exercises
                                              # the checkpoint/flightrec
                                              # SIGTERM chain)
    SLU_TPU_CHAOS='nan_supernode=3'         # poison supernode 3's values
    SLU_TPU_CHAOS='kill_rank=1@group=3'     # only rank 1 dies, after its
                                              # dispatch group 3 (the
                                              # rank-failure domain)
    SLU_TPU_CHAOS='kill_rank=1,kill_op=4'   # rank 1 dies right before its
                                              # 4th public collective
    SLU_TPU_CHAOS='stall_rank=1,secs=2'     # rank 1 sleeps 2 s before a
                                              # collective: slow, NOT dead
                                              # — the detector must not
                                              # declare it failed
    SLU_TPU_CHAOS='poison_rhs=17'           # NaN the 17th column ever
                                              # submitted to a SolveServer
                                              # (poisoned-request domain)
    SLU_TPU_CHAOS='slow_client=2,secs=1'    # the 2nd ticket's client
                                              # stalls 1 s before collecting
                                              # (never-collecting client)
    SLU_TPU_CHAOS='corrupt_panel=0'         # flip a byte in front group
                                              # 0's resident panel stack —
                                              # the scrubber must catch it
    SLU_TPU_CHAOS='kill_replica=1@batch=3'  # fleet replica 1 dies before
                                              # serving its 4th accepted
                                              # batch (a REAL SIGKILL in a
                                              # process replica, a simulated
                                              # crash in a thread replica) —
                                              # the zero-loss failover domain
    SLU_TPU_CHAOS='quarantine_replica=1'    # replica 1 quarantines before
                                              # its next batch — the router
                                              # must re-route, never error
    SLU_TPU_CHAOS='slow_replica=0,secs=1'   # replica 0 stalls 1 s before a
                                              # batch: slow, NOT dead — the
                                              # fleet health monitor must
                                              # yield ZERO false failovers
    SLU_TPU_CHAOS='kill_refactor@step=2'    # SIGKILL self MID-REFACTOR on
                                              # the 3rd refactor (shadow
                                              # numeric started, nothing
                                              # adopted) — the previous
                                              # handle must keep serving
    SLU_TPU_CHAOS='poison_values=3'         # NaN the new-values entry
                                              # assembling into supernode 3
                                              # mid-refactor — the canary /
                                              # sentinels must roll back,
                                              # adopting nothing

The factor path consults :func:`get_chaos` once per factorization
(numeric/factor.py) and the streamed executor calls
:meth:`ChaosMonkey.on_group` after each completed dispatch group — a
no-op None when the knob is unset, so the production hot path pays one
``is None`` test.  The serving tier consults :func:`get_serve_chaos` and
:func:`get_fleet_chaos`, ``drivers/gssvx.refactor``
:func:`get_refactor_chaos`.

Helpers for tests that inject from OUTSIDE the victim:

* :func:`corrupt_file` — deterministic bit-flip / truncation of a
  checkpoint artifact (drives the persist integrity paths);
* :class:`CountdownDeadline` — a deadline that expires at the Nth poll;
* :class:`HangWatchdog` — bounds a hang: dump the flight recorder and
  ``os._exit`` after a timeout unless disarmed.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading

import numpy as np
import torch

from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
from superlu_dist_tpu_torch.utils.deadline import Deadline

#: exit code of a DyingTreeComm rank (distinct from a crash)
RANK_DEATH_EXIT = 17
#: exit code of a HangWatchdog abort
HANG_EXIT = 3


@dataclasses.dataclass
class ChaosPlan:
    """Parsed injection spec (all fields optional; -1 / "" = off)."""

    kill_group: int = -1      # kill self after completing this group
    signal: str = "kill"      # "kill" (SIGKILL, the kill -9 domain) or
                              # "term" (SIGTERM — handlers run first)
    nan_supernode: int = -1   # poison this supernode's A-entries
    # ---- rank-failure domain (parallel/treecomm.TreeComm) -------------
    kill_rank: int = -1       # scope kill_group/kill_op to this rank
                              # (-1 = any rank, the single-process case)
    kill_op: int = -1         # die right before this public collective
                              # (1-based count on the victim's TreeComm)
    stall_rank: int = -1      # this rank sleeps `secs` before a
    secs: float = 0.0         # collective — slow-NOT-dead injection
    stall_op: int = 1         # ...before this public collective
    epoch: int = 0            # comm/serve injections fire only in this
                              # TreeComm epoch (so a shrunken/respawned
                              # recovery epoch is not re-injected)
    # ---- serving-tier domain ------------------------------------------
    poison_rhs: int = -1      # NaN the Cth SUBMITTED column (global
                              # column counter across all submits)
    slow_client: int = -1     # the Tth submitted ticket's client never
                              # collects (result() stalls `secs` first)
    corrupt_panel: int = -1   # flip one byte of front group F's
                              # resident L stack before the next scrub
    # ---- fleet domain -------------------------------------------------
    kill_replica: int = -1    # this fleet replica dies (SIGKILL in a
                              # process replica, simulated crash in a
                              # thread replica)...
    batch: int = -1           # ...before serving its Kth accepted
                              # batch (0-based per-replica count)
    quarantine_replica: int = -1  # this replica quarantines before its
                              # next batch (unroutable, NOT dead)
    slow_replica: int = -1    # this replica stalls `secs` once before
                              # a batch — slow, NOT dead: the health
                              # monitor must not fail it over
    # ---- refactor domain ----------------------------------------------
    kill_refactor: int = -1   # kill self MID-REFACTOR (shadow numeric
                              # running, nothing adopted yet) on the
                              # Kth refactor of this process (0-based;
                              # spec shorthand kill_refactor@step=K) —
                              # the interrupted-refactor domain: the
                              # previous handle must keep serving
    poison_values: int = -1   # NaN the new-values entry assembling into
                              # supernode S mid-refactor (same targeting
                              # as nan_supernode, scoped to refactor) —
                              # the sentinels/canary must reject and
                              # roll back, adopting nothing

    @property
    def armed(self) -> bool:
        return (self.kill_group >= 0 or self.nan_supernode >= 0
                or self.comm_armed or self.serve_armed
                or self.fleet_armed or self.refactor_armed)

    @property
    def comm_armed(self) -> bool:
        return self.kill_op >= 0 or self.stall_rank >= 0

    @property
    def serve_armed(self) -> bool:
        return (self.poison_rhs >= 0 or self.slow_client >= 0
                or self.corrupt_panel >= 0)

    @property
    def fleet_armed(self) -> bool:
        return (self.kill_replica >= 0 or self.quarantine_replica >= 0
                or self.slow_replica >= 0)

    @property
    def refactor_armed(self) -> bool:
        return self.kill_refactor >= 0 or self.poison_values >= 0


def parse_chaos_spec(spec: str) -> ChaosPlan:
    """'kill_group=5,signal=term' -> ChaosPlan.  Unknown keys raise —
    a typo'd knob silently injecting nothing would defeat the test.  'kill_rank=R@group=G' is the
    rank-failure shorthand: rank R SIGKILLs itself after its dispatch
    group G."""
    plan = ChaosPlan()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key == "kill_rank":
            rank, at, group = val.partition("@group=")
            plan.kill_rank = int(rank)
            if at:
                plan.kill_group = int(group)
        elif key == "kill_replica":
            rid, at, batch = val.partition("@batch=")
            plan.kill_replica = int(rid)
            plan.batch = int(batch) if at else 0
        elif key == "kill_refactor@step" or key == "kill_refactor":
            # 'kill_refactor@step=K' (the documented shorthand) or the
            # plain 'kill_refactor=K' both mean: die mid-refactor on
            # the Kth refactor of this process
            plan.kill_refactor = int(val)
        elif key in ("kill_group", "nan_supernode", "kill_op",
                     "stall_rank", "stall_op", "epoch", "poison_rhs",
                     "slow_client", "corrupt_panel", "batch",
                     "quarantine_replica", "slow_replica",
                     "poison_values"):
            setattr(plan, key, int(val))
        elif key == "secs":
            plan.secs = float(val)
        elif key == "signal":
            val = val.strip().lower()
            if val not in ("kill", "term"):
                raise ValueError(
                    f"chaos signal must be 'kill' or 'term', got {val!r}")
            plan.signal = val
        else:
            raise ValueError(f"unknown chaos-injection knob {key!r}")
    return plan


# the victim's distributed identity, bound by TreeComm construction (and
# re-bound with the ORIGINAL rank id by recovery epochs, so a survivor
# renumbered into a dead rank's slot never inherits its injection)
_BOUND = {"rank": -1, "epoch": 0}


def bind_rank(rank: int, epoch: int = 0) -> None:
    """Record this process's rank identity for rank-scoped injections
    (called by TreeComm.__init__ / recovery epoch builds)."""
    _BOUND["rank"] = int(rank)
    _BOUND["epoch"] = int(epoch)


def bound_rank() -> tuple:
    """The (rank, epoch) identity last bound (``bind_rank``)."""
    return _BOUND["rank"], _BOUND["epoch"]


class ChaosMonkey:
    """One factorization's injector (built from a ChaosPlan)."""

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self.groups_seen = 0
        self._stalled = False
        self._panel_corrupted = False
        self._values_poisoned = False

    def _kill_self(self) -> None:
        sig = (signal.SIGTERM if self.plan.signal == "term"
               else signal.SIGKILL)
        os.kill(os.getpid(), sig)
        if sig == signal.SIGTERM:
            # handlers (checkpoint flush, flightrec dump) ran and
            # chained to the default disposition; if something
            # swallowed it, die anyway — the injection must kill
            os.kill(os.getpid(), signal.SIGKILL)

    # ---- process-kill domain -------------------------------------------
    def on_group(self, gi: int) -> None:
        """Called by the streamed executor after group ``gi`` completes.
        The kill lands AFTER the group's panels are emitted (and after
        any interval checkpoint for it), modeling a preemption between
        dispatch groups — the boundary the resume path restarts from.
        ``kill_rank=R@group=G`` scopes the kill to the rank bound by
        :func:`bind_rank` (any rank when unscoped — the single-process
        back-compat case), in epoch ``epoch`` only."""
        self.groups_seen += 1
        if gi != self.plan.kill_group:
            return
        if self.plan.kill_rank >= 0 and (
                _BOUND["rank"] != self.plan.kill_rank
                or _BOUND["epoch"] != self.plan.epoch):
            return
        self._kill_self()

    # ---- rank-failure domain (comm layer) -------------------------------
    def on_collective(self, seq: int, rank: int, epoch: int) -> None:
        """Called by TreeComm at every outermost public collective
        (``seq`` is 1-based).  ``kill_op`` dies right BEFORE entering
        the op — the silent-rank domain the failure detector must
        convert into RankFailureError on the peers; ``stall_rank`` just
        sleeps, and the detector must NOT declare it failed."""
        p = self.plan
        if epoch != p.epoch:
            return
        if p.kill_op >= 0 and seq >= p.kill_op and \
                p.kill_rank in (-1, rank):
            self._kill_self()
        if p.stall_rank == rank and not self._stalled and \
                seq >= p.stall_op and p.secs > 0:
            self._stalled = True
            import time
            time.sleep(p.secs)

    # ---- serving-tier domain (SolveServer hooks) ------------------------
    def _serve_epoch_ok(self) -> bool:
        # serve injections are epoch-scoped like the comm ones: a server
        # rebuilt inside a recovery epoch is never re-injected
        return _BOUND["epoch"] == self.plan.epoch

    def poison_submit(self, b2: np.ndarray, col0: int) -> np.ndarray:
        """``poison_rhs=C``: if the Cth globally-submitted column falls
        in this request's ``[col0, col0+k)`` range, return a COPY with
        that column NaN'd — the poisoned-request domain the isolation
        path must confine to one ticket.  No-op (same array) otherwise."""
        c = self.plan.poison_rhs
        if c < 0 or not self._serve_epoch_ok():
            return b2
        if not (col0 <= c < col0 + b2.shape[1]):
            return b2
        out = np.array(b2, copy=True)
        out[:, c - col0] = np.nan
        return out

    def is_slow_client(self, ticket_index: int) -> bool:
        """``slow_client=T``: the Tth submitted ticket's client never
        collects promptly — its ``result()`` stalls ``secs`` first (the
        served answer must survive uncollected; the server must never
        block on it)."""
        return (self.plan.slow_client == ticket_index
                and self._serve_epoch_ok())

    def corrupt_resident_panel(self, fronts) -> int:
        """``corrupt_panel=F``: flip one byte in front group F's
        resident L panel stack (in-place in the fronts list — the
        handle now SERVES from the corrupted stack), modeling the
        silent HBM/DRAM bit rot the integrity scrubber exists to catch.
        Fires once; returns the corrupted group index or -1."""
        f = self.plan.corrupt_panel
        if f < 0 or self._panel_corrupted or not self._serve_epoch_ok():
            return -1
        if not (0 <= f < len(fronts)):
            raise ValueError(
                f"chaos corrupt_panel={f}: handle has only "
                f"{len(fronts)} front groups")
        lp, up = fronts[f]
        if isinstance(lp, np.ndarray):
            buf = np.array(lp, copy=True)
            raw = buf.view(np.uint8).reshape(-1)
        else:
            # a resident torch panel stack: flip the byte in a copy on its
            # own device (a byte view of the contiguous clone)
            buf = lp.detach().clone().contiguous()
            raw = buf.view(-1).view(torch.uint8)
        raw[raw.shape[0] // 2] ^= 0xFF      # deterministic single flip
        fronts[f] = (buf, up)
        self._panel_corrupted = True
        return f

    # ---- fleet domain (FleetRouter replica hooks) ------------------------
    def replica_kill_due(self, rid: int, batch_index: int) -> bool:
        """``kill_replica=R@batch=K``: True when replica ``rid`` must
        die before serving its ``batch_index``-th accepted batch
        (0-based per-replica count).  The caller decides how to die: a
        process replica SIGKILLs itself (the real kill -9 domain), a
        thread replica simulates the crash (stops serving with its
        accepted tickets undelivered) — either way the router must
        re-route every undelivered ticket with zero client-visible
        loss.  Epoch-scoped like every serve injection."""
        p = self.plan
        return (p.kill_replica == rid and p.batch >= 0
                and batch_index >= p.batch and self._serve_epoch_ok())

    def replica_quarantined(self, rid: int) -> bool:
        """``quarantine_replica=R``: replica ``rid`` flips to
        quarantined before its next batch — unroutable but ALIVE, the
        degraded-not-dead domain the router must route around (and
        re-route the replica's queued tickets) without erroring any
        client."""
        return (self.plan.quarantine_replica == rid
                and self._serve_epoch_ok())

    def replica_stall_s(self, rid: int) -> float:
        """``slow_replica=R,secs=S``: replica ``rid`` stalls S seconds
        ONCE before a batch.  Slow is NOT dead: the health monitor's
        liveness verdict (pid/thread, never latency) must produce zero
        false-positive failovers.  Returns the stall (0.0 after the
        first fire / for other replicas)."""
        p = self.plan
        if (p.slow_replica != rid or self._stalled
                or p.secs <= 0 or not self._serve_epoch_ok()):
            return 0.0
        self._stalled = True
        return p.secs

    # ---- refactor domain (drivers/gssvx.refactor hooks) ------------------
    def refactor_kill_due(self, step_index: int) -> bool:
        """``kill_refactor@step=K``: True when the ``step_index``-th
        refactor of this process (0-based count, maintained by the
        caller) must die MID-REFACTOR — after the shadow numeric
        factorization has started, before anything is adopted.  The
        caller SIGKILLs via :meth:`kill_now`; crash consistency demands
        the previous handle (and any bundle on disk) stay untouched.
        Epoch-scoped like every serve injection."""
        p = self.plan
        return (p.kill_refactor >= 0 and step_index >= p.kill_refactor
                and self._serve_epoch_ok())

    def kill_now(self) -> None:
        """The injected death itself (SIGKILL, or SIGTERM under
        ``signal=term`` — exercising the checkpoint/flightrec SIGTERM
        chain before dying)."""
        self._kill_self()

    def poison_refactor_values(self, plan,
                               bvals: np.ndarray) -> np.ndarray:
        """``poison_values=S``: NaN the NEW values' entry that assembles
        into supernode S — the poisoned-refactor domain: the breakdown
        sentinels (or the BERR canary) must reject the shadow factors
        and the refactor must roll back adopting nothing.  Same
        deterministic targeting as :meth:`poke_nan`; fires once per
        monkey; returns a poisoned COPY (no-op otherwise)."""
        s = self.plan.poison_values
        if s < 0 or self._values_poisoned or not self._serve_epoch_ok():
            return bvals
        self._values_poisoned = True
        # clamp to the plan's supernode count so one spec drives tests
        # of every problem size (deterministic either way)
        s = min(s, len(plan.sn_group) - 1)
        sub = dataclasses.replace(self.plan, nan_supernode=s,
                                  poison_values=-1)
        return ChaosMonkey(sub).poke_nan(plan, bvals)

    # ---- numeric-poison domain -----------------------------------------
    def poke_nan(self, plan, pattern_values: np.ndarray) -> np.ndarray:
        """Poison supernode ``nan_supernode``: NaN one A-entry that
        assembles into its front, so the non-finite sentinel must trip
        AT that supernode (localization is part of what chaos tests
        pin).  Returns a poisoned COPY; no-op when unarmed."""
        s = self.plan.nan_supernode
        if s < 0:
            return pattern_values
        g = int(plan.sn_group[s])
        slot = int(plan.sn_slot[s])
        grp = plan.groups[g]
        hit = np.nonzero(np.asarray(grp.a_slot) == slot)[0]
        if not len(hit):
            raise ValueError(
                f"chaos nan_supernode={s}: supernode assembles no "
                "A-entries (fully fill-in front) — pick another target")
        out = np.array(pattern_values, copy=True)
        out[np.asarray(grp.a_src)[hit[0]]] = np.nan
        return out


def get_chaos() -> ChaosMonkey | None:
    """The env-armed injector, or None (the production fast path).
    Re-read per call: chaos specs are per-run test state, not a latched
    process constant."""
    from superlu_dist_tpu_torch.utils.options import env_str
    spec = env_str("SLU_TPU_CHAOS").strip()
    if not spec:
        return None
    plan = parse_chaos_spec(spec)
    return ChaosMonkey(plan) if plan.armed else None


def get_comm_chaos() -> ChaosMonkey | None:
    """Comm-layer injector for TreeComm (kill_op / stall_rank specs).
    None unless a COMM injection is armed, so the per-collective hook
    stays one ``is None`` test on the production path."""
    monkey = get_chaos()
    if monkey is None or not monkey.plan.comm_armed:
        return None
    return monkey


def get_serve_chaos() -> ChaosMonkey | None:
    """Serving-tier injector for SolveServer (poison_rhs / slow_client /
    corrupt_panel specs).  Consulted ONCE at server construction — a
    server's lifetime is the run — and None unless a serve injection is
    armed, so submit/scrub hooks stay one ``is None`` test."""
    monkey = get_chaos()
    if monkey is None or not monkey.plan.serve_armed:
        return None
    return monkey


def get_refactor_chaos() -> ChaosMonkey | None:
    """Refactor-domain injector for ``drivers/gssvx.refactor``
    (kill_refactor / poison_values specs).  Consulted ONCE per refactor
    — each refactor call gets its own monkey so the fire-once poison
    latch is per-refactor state — and None unless a refactor injection
    is armed, so the production refactor path pays one ``is None``
    test."""
    monkey = get_chaos()
    if monkey is None or not monkey.plan.refactor_armed:
        return None
    return monkey


def get_fleet_chaos() -> ChaosMonkey | None:
    """Fleet-domain injector for FleetRouter replicas (kill_replica /
    quarantine_replica / slow_replica specs).  Consulted once per
    replica at construction — each replica gets its OWN monkey so the
    fire-once stall/kill flags are per-replica state — and None unless
    a fleet injection is armed, so the replica serve loop stays one
    ``is None`` test."""
    monkey = get_chaos()
    if monkey is None or not monkey.plan.fleet_armed:
        return None
    return monkey


# ---------------------------------------------------------------------------
# outside-the-victim helpers
# ---------------------------------------------------------------------------

def corrupt_file(path: str, mode: str = "flip", offset: int | None = None,
                 keep: int | None = None) -> None:
    """Deterministically damage an on-disk artifact.

    mode="flip": XOR one byte (at ``offset``, default the middle of the
    file) — drives the sha256-mismatch path.  mode="truncate": cut the
    file to ``keep`` bytes (default half) — drives the truncated-array
    path.  Checkpoint loads must answer with structured
    CheckpointCorruptError, never garbage factors."""
    size = os.path.getsize(path)
    if mode == "flip":
        off = size // 2 if offset is None else offset
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    elif mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2 if keep is None else keep)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


class DyingTreeComm(TreeComm):
    """A rank that dies mid-protocol: after ``die_after`` completed
    public collectives the NEXT one ``os._exit``\\ s with
    :data:`RANK_DEATH_EXIT` instead of participating — the simulated
    rank-death failure domain.  With ``SLU_TPU_COMM_TIMEOUT_S`` armed
    the peers' failure detector converts the abandoned collective into
    :class:`RankFailureError` on every survivor; with bounded waits OFF
    the peers hang, which is what :class:`HangWatchdog` exists to
    bound."""

    def __init__(self, *args, die_after: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._die_after = int(die_after)
        self._public_ops = 0

    def _maybe_die(self):
        if self._public_ops >= self._die_after:
            os._exit(RANK_DEATH_EXIT)
        self._public_ops += 1

    def bcast_any(self, arr, root=0):
        self._maybe_die()
        return super().bcast_any(arr, root=root)

    def reduce_sum_any(self, arr, root=0):
        self._maybe_die()
        return super().reduce_sum_any(arr, root=root)

    def allreduce_sum_any(self, arr, root=0):
        self._maybe_die()
        return super().allreduce_sum_any(arr, root=root)


class CountdownDeadline(Deadline):
    """Deterministic deadline injection: 'expires' at the Nth poll
    instead of on the wall clock, so tests can cancel a factorization
    at an exact dispatch-group boundary (the group loop polls once per
    group).  Everything else — checkpoint-first flush, the collective
    flag allreduce, the structured raise — runs the production path."""

    def __init__(self, fire_after_polls: int, comm=None,
                 poll_every: int = 1):
        super().__init__(seconds=0.0, comm=comm, poll_every=poll_every)
        self.fire_after_polls = int(fire_after_polls)

    def expired_local(self) -> bool:
        return self.polls > self.fire_after_polls


class HangWatchdog:
    """Bounded-hang guard of LAST RESORT for chaos tests and serving
    loops: unless :meth:`disarm` runs within ``seconds``, flush any
    active factor checkpoint, dump the flight recorder (when enabled)
    and ``os._exit(exit_code)``.  A daemon timer — deliberately NOT a
    signal, so it fires even while the main thread is blocked inside a
    native call or a device synchronization."""

    def __init__(self, seconds: float, exit_code: int = HANG_EXIT,
                 reason: str = "hang-watchdog"):
        self.seconds = float(seconds)
        self.exit_code = int(exit_code)
        self.reason = reason
        self._timer = None

    def _fire(self):
        try:
            from superlu_dist_tpu_torch.persist.checkpoint import flush_active
            flush_active(self.reason)
            from superlu_dist_tpu_torch.obs.flightrec import get_flightrec
            fr = get_flightrec()
            if fr.enabled:
                fr.dump(self.reason)
        except Exception:
            pass
        os._exit(self.exit_code)

    def arm(self) -> "HangWatchdog":
        self._timer = threading.Timer(self.seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self):
        return self.arm()

    def __exit__(self, *exc):
        self.disarm()
        return False
