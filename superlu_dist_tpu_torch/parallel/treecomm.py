"""Host-side async tree broadcast / reduction.

Capability analog of the reference's C++11 tree-collective engine
(TreeBcast_slu.hpp, TreeReduce_slu.hpp, TreeInterface.cpp) — the
per-supernode broadcast and reduction trees that drive its distributed
triangular solve (pdgstrs.c:1444-1670).  Same topology rule: flat tree up
to 8 ranks, binary beyond (TreeBcast_slu.hpp:17-29).

Port of the JAX package's ``parallel/treecomm.py``: the *host-process*
orchestration layer of the distributed driver (parallel/pgssvx.py) —
multi-process single-node runs coordinate through a POSIX shared-memory
segment (native slu_tree_*, native/slu_host.cpp, the same source as the
JAX package's, so a rank of either package can join the other's domain)
instead of MPI point-to-point, with per-rank atomic sequence/ack counters
providing the async pipeline the reference gets from Isend/Irecv.  Ranks
are processes (spawned: a process that holds a CUDA context must not
fork) or threads of one process (ctypes releases the GIL in every native
leg).  Nothing here touches the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
import time

import numpy as np

from superlu_dist_tpu_torch import native
from superlu_dist_tpu_torch.obs.metrics import get_metrics
from superlu_dist_tpu_torch.obs.trace import get_tracer
from superlu_dist_tpu_torch.utils.stats import CommStats

class LockstepVerifier:
    """Runtime collective-lockstep verification (the run-time form of the
    JAX package's lint rule SLU106).

    With ``SLU_TPU_VERIFY_COLLECTIVES=1`` every public TreeComm
    collective is preceded by a digest exchange: each rank contributes a
    fixed-layout record of (sequence number, op kind, payload
    shape/dtype, root, call site) into its own slot of an
    ``n_ranks × REC`` matrix, summed over a SIBLING tree domain
    (``<name>.vfy`` — same native transport, its own segment so digests
    never perturb payload slots) and broadcast back.  Because the digest
    exchange has the identical native-leg structure on every rank
    regardless of WHICH public op the rank is entering, ranks that have
    diverged into different collectives still complete the exchange —
    and then every rank sees every rank's record, detects the mismatch,
    and raises :class:`CollectiveMismatchError` naming the divergent
    call sites, instead of hanging inside mismatched payload legs (the
    MUST-style deadlock-to-diagnosis conversion; the reference's
    collectives offer no such guard).

    Composite ops verify ONCE at their public entry (``depth`` guards
    the inner legs), so the digest carries the caller's intent —
    ``allreduce_sum_any`` with the real payload shape/dtype — not the
    transport decomposition.  The digest exchange rides the owning
    TreeComm's bounded-wait legs, so with ``SLU_TPU_COMM_TIMEOUT_S`` set
    a rank that stops calling collectives altogether (died, hung)
    surfaces as :class:`RankFailureError` on every peer — SILENCE is
    covered by the failure detector the same way DIVERGENCE is covered
    by the digest cross-check; neither hangs the fleet.
    """

    SHAPE_SLOTS = 3
    DTYPE_CHARS = 12
    SITE_CHARS = 48
    REC = 5 + SHAPE_SLOTS + DTYPE_CHARS + SITE_CHARS

    _OPCODES = {op: i + 1 for i, op in enumerate((
        "bcast", "reduce", "reduce_sum", "allreduce", "allreduce_sum",
        "bcast_any", "reduce_sum_any", "allreduce_sum_any",
        "bcast_bytes", "bcast_obj"))}

    def __init__(self, lib, name: bytes, n_ranks: int, rank: int,
                 create: bool):
        self._lib = lib
        self.name = bytes(name) + b".vfy"
        self.n_ranks = int(n_ranks)
        self.rank = int(rank)
        self.seq = 0
        self.depth = 0
        self.checks = 0
        self._h = lib.slu_tree_attach(self.name, self.n_ranks,
                                      self.n_ranks * self.REC, self.rank,
                                      1 if create else 0)
        if not self._h:
            raise OSError(f"slu_tree_attach failed for verifier domain "
                          f"{self.name!r}")
        self._created = bool(create)
        # set by the owning TreeComm: routes the digest exchange through
        # its bounded-wait leg policy (timeout + failure detector), so a
        # silent rank fails this exchange structurally too
        self.comm = None

    # ---- lifecycle -----------------------------------------------------
    def close(self, unlink: bool | None = None):
        if self._h:
            if unlink is None:
                unlink = self._created
            self._lib.slu_tree_detach(self._h, self.name,
                                      1 if unlink else 0)
            self._h = None

    # ---- the check -----------------------------------------------------
    @contextlib.contextmanager
    def guard(self, op, shape, dtype, root):
        """Verify once at the outermost public op; inner legs (composite
        decomposition, chunking, fault-injection retries) are exempt —
        their structure is a deterministic function of the verified
        public op."""
        if self.depth == 0:
            self.check(op, shape, dtype, root)
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1

    def check(self, op, shape, dtype, root):
        rec = self._encode(op, shape, dtype, root, _call_site())
        buf = np.zeros(self.n_ranks * self.REC, dtype=np.float64)
        buf[self.rank * self.REC:(self.rank + 1) * self.REC] = rec
        # digest allreduce over the sibling domain: identical native-leg
        # structure for every public op, so it completes even when the
        # public sequences have diverged; routed through the owning
        # TreeComm's bounded-wait policy so a SILENT (dead) rank raises
        # RankFailureError here instead of hanging the exchange
        if self.comm is not None:
            self.comm._native_leg("reduce_sum", buf, 0, handle=self._h,
                                  op_name=f"verify:{op}")
            self.comm._native_leg("bcast", buf, 0, handle=self._h,
                                  op_name=f"verify:{op}")
        else:
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            self._lib.slu_tree_reduce_sum(self._h, 0, ptr, buf.size)
            self._lib.slu_tree_bcast(self._h, 0, ptr, buf.size)
        self.seq += 1
        self.checks += 1
        mat = buf.reshape(self.n_ranks, self.REC)
        # the call-site chars are informational (SPMD peers legitimately
        # reach the SAME collective from different source lines — owner
        # vs worker driver code); semantic lockstep is (seq, op, root,
        # shape, dtype)
        sem = mat[:, :5 + self.SHAPE_SLOTS + self.DTYPE_CHARS]
        if (sem == sem[0]).all():
            return
        from superlu_dist_tpu_torch.utils.errors import CollectiveMismatchError
        records = [self._decode(r, mat[r]) for r in range(self.n_ranks)]
        tr = get_tracer()
        if tr.enabled:
            t0 = time.perf_counter()
            tr.complete("collective-mismatch", "verify", t0, 0.0,
                        rank=self.rank, seq=self.seq - 1,
                        sites=";".join(x["site"] for x in records))
        raise CollectiveMismatchError(records, rank=self.rank)

    # ---- record layout --------------------------------------------------
    def _encode(self, op, shape, dtype, root, site):
        rec = np.zeros(self.REC, dtype=np.float64)
        shape = tuple(int(s) for s in tuple(shape)[:self.SHAPE_SLOTS])
        rec[0] = self.seq
        rec[1] = self._OPCODES.get(op, 0)
        rec[2] = int(root)
        rec[3] = len(shape)
        rec[4] = float(np.prod(shape, dtype=np.float64)) if shape else 0.0
        rec[5:5 + len(shape)] = shape
        base = 5 + self.SHAPE_SLOTS
        for i, ch in enumerate(str(dtype)[:self.DTYPE_CHARS]):
            rec[base + i] = ord(ch)
        base += self.DTYPE_CHARS
        for i, ch in enumerate(site[-self.SITE_CHARS:]):
            rec[base + i] = ord(ch)
        return rec

    def _decode(self, rank, rec):
        ndim = int(rec[3])
        base = 5 + self.SHAPE_SLOTS
        names = {v: k for k, v in self._OPCODES.items()}
        chars = (lambda lo, n: "".join(
            chr(int(c)) for c in rec[lo:lo + n] if int(c) > 0))
        return {
            "rank": rank,
            "seq": int(rec[0]),
            "op": names.get(int(rec[1]), f"op#{int(rec[1])}"),
            "root": int(rec[2]),
            "shape": tuple(int(s) for s in
                           rec[5:5 + min(ndim, self.SHAPE_SLOTS)]),
            "dtype": chars(base, self.DTYPE_CHARS),
            "site": chars(base + self.DTYPE_CHARS, self.SITE_CHARS),
        }


def _call_site() -> str:
    """First stack frame outside this module (and outside contextlib —
    the guard is a generator context manager, so its immediate caller is
    ``contextlib.__enter__``): the caller-level source location the
    mismatch report names, kept to the trailing two path components so
    records fit the fixed digest slot."""
    skip = {os.path.abspath(__file__),
            os.path.abspath(contextlib.__file__)}
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) in skip:
        f = f.f_back
    if f is None:
        return "<unknown>"
    parts = f.f_code.co_filename.replace(os.sep, "/").split("/")
    return "/".join(parts[-2:]) + f":{f.f_lineno}"


def _is_zombie(pid: int) -> bool:
    """True when /proc says the process is a zombie (Linux; False where
    /proc is unavailable — there kill(pid, 0) alone decides)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # field 3, after the parenthesized comm (which may contain spaces)
        return data.rsplit(b")", 1)[1].split()[0] == b"Z"
    except (OSError, IndexError):
        return False


def pid_alive(pid: int) -> bool:
    """The process-liveness verdict of the failure detector, factored
    out so the serving fleet (serve/fleet.py) judges replica processes
    by the SAME discipline it judges ranks: ``kill(pid, 0)`` raising
    ``ProcessLookupError`` is death, EPERM is alive, and an unreaped
    ZOMBIE (dead child the detecting parent has not waited on) counts
    as dead for every communication purpose.  A pid that is merely
    slow ALWAYS answers alive — slow-not-dead is decided here, nowhere
    else."""
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return not _is_zombie(pid)


class FailureDetector:
    """Per-rank heartbeat + pid liveness + the ``.ftx`` agreement board.

    The shared segment of the COLLECTIVE domain carries, per rank, a
    pid slot (written once at attach) and a heartbeat epoch (bumped by
    a daemon thread every ``SLU_TPU_HEARTBEAT_S``).  Liveness is judged
    by the *process*, not the heartbeat: ``os.kill(pid, 0)`` raising
    ``ProcessLookupError`` is the death verdict, so a rank whose
    heartbeat thread died with it is still detected — and a STALLED
    rank (alive pid, stale heartbeat) is never declared failed, only
    waited on (the slow-not-dead discipline; ``heartbeat_age`` is a
    gauge, not a verdict).

    The agreement board is a SIBLING shared-memory domain
    (``<name>.ftx``) used only through the wait-free post/peek
    primitives: each survivor publishes its observed dead-set into its
    OWN slot and polls the others — by construction nothing on this
    domain ever blocks on the dead rank, which is how the survivors
    converge on one dead-set (ULFM's revoke→agree shape) and all raise
    the same :class:`RankFailureError`.
    """

    BOARD_LEN = 4          # [MAGIC, epoch, dead-mask, pad]
    MAGIC = 7355.0

    def __init__(self, lib, name: bytes, n_ranks: int, rank: int,
                 create: bool, main_handle):
        if n_ranks > 52:
            raise ValueError("failure detector dead-mask rides the f64 "
                             f"mantissa: n_ranks {n_ranks} > 52")
        self._lib = lib
        self.name = bytes(name) + b".ftx"
        self.n_ranks = int(n_ranks)
        self.rank = int(rank)
        self._main = main_handle      # pid/hb slots live in the MAIN domain
        self._h = lib.slu_tree_attach(self.name, self.n_ranks,
                                      self.BOARD_LEN, self.rank,
                                      1 if create else 0)
        if not self._h:
            raise OSError(f"slu_tree_attach failed for detector domain "
                          f"{self.name!r}")
        self._created = bool(create)
        self._hb_stop = threading.Event()
        self._hb_thread = None
        #: the longest time between two of MY heartbeats (the heartbeat
        #: thread starved of the GIL, e.g. during a long factorization)
        self.max_beat_gap_s = 0.0
        # rank -> (last seen hb count, monotonic time it changed): the
        # heartbeat-age gauge's bookkeeping
        self._hb_seen: dict = {}

    # ---- heartbeat ------------------------------------------------------
    def start_heartbeat(self, interval: float) -> None:
        if self._hb_thread is not None or interval <= 0:
            return

        def run():
            m = get_metrics()
            last = time.monotonic()
            while not self._hb_stop.wait(interval):
                h = self._h
                if h is None:
                    return
                self._lib.slu_tree_heartbeat(self._main)
                now = time.monotonic()
                self.max_beat_gap_s = max(self.max_beat_gap_s, now - last)
                last = now
                if m.enabled:
                    for r in range(self.n_ranks):
                        m.set("slu_heartbeat_age_seconds",
                              self.heartbeat_age(r), rank=str(r))

        self._hb_thread = threading.Thread(
            target=run, name="slu-heartbeat", daemon=True)
        self._hb_thread.start()

    def heartbeat_age(self, rank: int) -> float:
        """Seconds since ``rank``'s heartbeat epoch last advanced (0.0
        for my own rank and for counters seen to move this poll)."""
        now = time.monotonic()
        if rank == self.rank:
            return 0.0
        cur = int(self._lib.slu_tree_get_heartbeat(self._main, rank))
        seen = self._hb_seen.get(rank)
        if seen is None or seen[0] != cur:
            self._hb_seen[rank] = (cur, now)
            return 0.0
        return now - seen[1]

    # ---- liveness -------------------------------------------------------
    def pid(self, rank: int) -> int:
        return int(self._lib.slu_tree_get_pid(self._main, rank))

    def dead_ranks(self) -> set:
        """Ranks whose registered pid no longer exists.  A rank that
        never registered (pid 0) is UNKNOWN, not dead; a pid we may not
        signal (EPERM) is alive.  An unreaped ZOMBIE (a dead child
        whose parent — often the detecting test harness itself — has
        not waited on it yet) still answers ``kill(pid, 0)``, so on
        Linux the /proc state is consulted too: Z is dead for every
        communication purpose."""
        out = set()
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            p = self.pid(r)
            if p <= 0:
                continue
            if not pid_alive(p):
                out.add(r)
        return out

    # ---- agreement board ------------------------------------------------
    def post_failure(self, dead: set, epoch: int) -> None:
        buf = np.zeros(self.BOARD_LEN, dtype=np.float64)
        buf[0] = self.MAGIC
        buf[1] = float(epoch)
        buf[2] = float(sum(1 << int(r) for r in dead))
        self._lib.slu_tree_post(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            buf.size)

    def posted_failures(self, epoch: int) -> dict:
        """{rank: dead-set} of every peer that has posted a failure
        declaration for this epoch (non-blocking)."""
        out = {}
        buf = np.zeros(self.BOARD_LEN, dtype=np.float64)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        for r in range(self.n_ranks):
            if r == self.rank:
                continue
            v = int(self._lib.slu_tree_peek(self._h, r, ptr, buf.size))
            if v <= 0 or buf[0] != self.MAGIC or int(buf[1]) != epoch:
                continue
            mask = int(buf[2])
            out[r] = {i for i in range(self.n_ranks) if mask >> i & 1}
        return out

    def close(self, unlink: bool | None = None) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            # bounded join (SLU110): the daemon wakes from its
            # stop-event wait immediately; never leave it racing the
            # segment unmap below or interpreter teardown
            self._hb_thread.join(2.0)
            self._hb_thread = None
        if self._h:
            if unlink is None:
                unlink = self._created
            self._lib.slu_tree_detach(self._h, self.name,
                                      1 if unlink else 0)
            self._h = None


class TreeComm:
    """One rank's attachment to a named tree-collective domain.

    Every participating process constructs TreeComm with the same name,
    n_ranks and max_len; rank 0 creates the segment.  All ranks must
    reach the collectives in the same order (the usual collective
    contract — the reference's trees are likewise matched per supernode).

    Rendezvous contract: the creator's constructor must COMPLETE before
    any attacher's starts (spawn workers after constructing the creator,
    as the tests do).  An attacher racing an in-flight create could bind
    a stale same-named segment from a crashed earlier run — the creator
    unlinks and re-creates exclusively, so such an attacher would wait
    on an orphan.  This happens-before requirement is what MPI_Init
    provides the reference for free; here it is the caller's.
    """

    def __init__(self, name: str, n_ranks: int, rank: int,
                 max_len: int = 4096, create: bool | None = None):
        lib = native.load()          # raises when it cannot be built
        self._lib = lib
        self.name = name.encode() if isinstance(name, str) else name
        self.n_ranks = int(n_ranks)
        self.rank = int(rank)
        self.max_len = int(max_len)
        if create is None:
            create = rank == 0
        self._h = lib.slu_tree_attach(self.name, self.n_ranks,
                                      self.max_len, self.rank,
                                      1 if create else 0)
        if not self._h:
            raise OSError(f"slu_tree_attach failed for {name!r}")
        self._created = bool(create)
        # per-op comm telemetry (the PROFlevel≥1 comm split): every
        # native collective leg accounts calls/bytes/seconds here, split
        # by op kind; composite ops (allreduce, bcast_bytes/bcast_obj)
        # relabel their legs via _op_label so attribution follows the
        # caller's intent, not the transport decomposition
        self.comm_stats = CommStats()
        self._op_label = None
        # serving metrics (obs/metrics.py): latched once — the disabled
        # path costs ONE `is None` test per collective leg, allocates
        # nothing (the NULL_TRACER discipline)
        m = get_metrics()
        self._metrics = m if m.enabled else None
        # lockstep-verify mode (runtime SLU106): OFF means NO verifier
        # state at all — self._verifier stays None and the collective
        # path pays one attribute test (see _entered)
        from superlu_dist_tpu_torch.utils.options import (env_flag, env_float,
                                                    env_int)
        self._verifier = None
        if env_flag("SLU_TPU_VERIFY_COLLECTIVES"):
            self._verifier = LockstepVerifier(lib, self.name, self.n_ranks,
                                              self.rank, bool(create))
            self._verifier.comm = self
        # rank-failure tolerance: register my pid in the shared segment
        # (peers poll it for liveness), and with a comm timeout armed
        # build the failure detector + heartbeat.  Timeout unset (the
        # default) keeps the unbounded waits and allocates NO detector
        # state.
        lib.slu_tree_set_pid(self._h, os.getpid())
        self.epoch = 0                 # bumped by recovery rebuilds
        self.seq = 0                   # public collective count
        self._depth = 0                # public-entry nesting guard
        self._timeout_s = float(env_float("SLU_TPU_COMM_TIMEOUT_S"))
        self._retries = int(env_int("SLU_TPU_COMM_RETRIES"))
        self._detector = None
        if self._timeout_s > 0:
            self._detector = FailureDetector(lib, self.name, self.n_ranks,
                                             self.rank, bool(create),
                                             self._h)
            self._detector.start_heartbeat(env_float("SLU_TPU_HEARTBEAT_S"))
        # comm-layer chaos injection (testing/chaos.py kill_rank/stall_rank
        # specs), latched once — None is the production fast path; the
        # bind gives rank-scoped FACTOR-loop injections (kill_rank@group)
        # this process's distributed identity
        from superlu_dist_tpu_torch.testing.chaos import bind_rank, get_comm_chaos
        bind_rank(self.rank, self.epoch)
        self._chaos = get_comm_chaos()

    @contextlib.contextmanager
    def _entered(self, op: str, shape, dtype, root: int):
        """Public-collective entry: ONE nesting-guarded hook where, at
        the outermost op only, (a) the comm-chaos injector ticks, (b) a
        peer's posted rank-failure is joined (so ranks that are sailing
        ahead of the stuck subtree still raise promptly), and (c) the
        SLU106 lockstep digest is exchanged.  Inner legs of composite
        ops skip all three — their structure is a deterministic function
        of the verified public op."""
        outer = self._depth == 0
        self._depth += 1
        try:
            if outer:
                self.seq += 1
                c = self._chaos
                if c is not None:
                    c.on_collective(self.seq,
                                    getattr(self, "chaos_rank", self.rank),
                                    self.epoch)
                if self._detector is not None:
                    self._join_posted(op)
            v = self._verifier
            if v is None or not outer:
                yield
            else:
                with v.guard(op, shape, str(dtype), root):
                    yield
        finally:
            self._depth -= 1

    # ---- bounded-wait transport policy ---------------------------------
    def _native_leg(self, kind: str, buf: np.ndarray, root: int,
                    handle=None, op_name: str | None = None) -> None:
        """One native tree leg.  Without a comm timeout this is the
        legacy unbounded spin.  With ``SLU_TPU_COMM_TIMEOUT_S`` armed,
        the leg waits at most the timeout, then consults the failure
        detector: a DEAD peer converts the hang into a
        :class:`RankFailureError` on every survivor (agreement via the
        .ftx board); a live peer is retried — indefinitely by default,
        or up to ``SLU_TPU_COMM_RETRIES`` before
        :class:`CommTimeoutError` (the slow-not-dead verdict never
        declares a live rank failed)."""
        h = self._h if handle is None else handle
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        lib = self._lib
        if self._detector is None:
            if kind == "bcast":
                lib.slu_tree_bcast(h, int(root), ptr, buf.size)
            else:
                lib.slu_tree_reduce_sum(h, int(root), ptr, buf.size)
            return
        fn = (lib.slu_tree_bcast_tw if kind == "bcast"
              else lib.slu_tree_reduce_sum_tw)
        op = op_name or kind
        m = self._metrics
        attempts = 0
        while True:
            rc = int(fn(h, int(root), ptr, buf.size,
                        float(self._timeout_s)))
            if rc == 0:
                return
            stuck = rc - 1          # == n_ranks: unidentified (ack drain)
            attempts += 1
            if m is not None:
                m.inc("slu_comm_timeouts_total", 1.0, op=op)
            dead = self._detector.dead_ranks()
            posted = self._detector.posted_failures(self.epoch)
            if dead or posted:
                self._rank_failure(op, dead)
            if self._retries and attempts >= self._retries:
                from superlu_dist_tpu_torch.utils.errors import CommTimeoutError
                raise CommTimeoutError(op, stuck, self._timeout_s,
                                       attempts, seq=self.seq,
                                       site=_call_site())
            if m is not None:
                m.inc("slu_comm_retries_total", 1.0)

    def _join_posted(self, op: str) -> None:
        """Cheap board peek at public-collective entry: a peer already
        declared a failure for this epoch — join the agreement and raise
        here too, instead of discovering it only when MY leg eventually
        blocks on the stuck subtree."""
        if self._detector.posted_failures(self.epoch):
            self._rank_failure(op, set())

    def _rank_failure(self, op: str, dead: set):
        """Agreement + raise (never returns).  Converge on the union of
        every survivor's observed dead-set: post mine, merge the board
        and fresh pid scans, and wait (bounded by ~1 timeout) until
        every live peer has posted a matching set or died — then every
        survivor raises the SAME RankFailureError."""
        d = self._detector
        dead = set(dead) | d.dead_ranks()
        deadline = time.monotonic() + max(self._timeout_s, 0.5)
        posted_mask = None
        while True:
            posted = d.posted_failures(self.epoch)
            for peers in posted.values():
                dead |= peers
            if posted_mask != dead:
                d.post_failure(dead, self.epoch)
                posted_mask = set(dead)
                posted = d.posted_failures(self.epoch)
            live = [r for r in range(self.n_ranks)
                    if r != self.rank and r not in dead]
            # convergence on POSTS first: a survivor that already agreed
            # (posted this dead-set) and then exited — e.g. its caller
            # chose ft="abort" — must not be folded into THIS failure's
            # dead-set; only scan pids while still unconverged
            if all(posted.get(r) == dead for r in live):
                break
            dead |= d.dead_ranks()
            if time.monotonic() >= deadline:
                break               # late peers join via their own
            time.sleep(0.005)       # timeout or board check
        if self._metrics is not None:
            self._metrics.inc("slu_ft_failures_total", 1.0, op=op)
        from superlu_dist_tpu_torch.utils.errors import RankFailureError
        raise RankFailureError(dead, op=op, seq=self.seq,
                               site=_call_site(), rank=self.rank,
                               n_ranks=self.n_ranks, epoch=self.epoch)

    def _account(self, op: str, nbytes: int, t0: float, root: int):
        """One collective leg completed: count it, and emit a comm span
        when tracing is enabled (no formatting otherwise)."""
        dt = time.perf_counter() - t0
        self.comm_stats.add(op, nbytes, dt)
        tr = get_tracer()
        if tr.enabled:
            tr.complete(f"tree-{op}", "comm", t0, dt, op=op,
                        bytes=int(nbytes), root=int(root), rank=self.rank,
                        n_ranks=self.n_ranks)
        m = self._metrics
        if m is not None:
            m.inc("slu_comm_calls_total", 1.0, op=op)
            m.inc("slu_comm_bytes_total", float(nbytes), op=op)
            m.observe("slu_comm_seconds", dt, op=op)

    def _prep(self, buf: np.ndarray) -> np.ndarray:
        out = np.ascontiguousarray(buf, dtype=np.float64)
        if out.size > self.max_len:     # a real check — the native side
            raise ValueError(           # memcpys into a max_len slot
                f"payload {out.size} > max_len {self.max_len}")
        return out

    def bcast(self, buf: np.ndarray, root: int = 0) -> np.ndarray:
        """Broadcast root's buf to every rank.  USE THE RETURN VALUE:
        when the input is contiguous float64 the operation is in place,
        otherwise the result lives in the returned copy."""
        buf = self._prep(buf)
        op = self._op_label or "bcast"
        with self._entered("bcast", buf.shape, buf.dtype, root):
            t0 = time.perf_counter()
            self._native_leg("bcast", buf, root)
            self._account(op, buf.nbytes, t0, root)
        return buf

    def reduce_sum(self, buf: np.ndarray, root: int = 0) -> np.ndarray:
        """Elementwise sum onto root (the RETURNED array holds the total
        on the root; see bcast for the in-place caveat)."""
        buf = self._prep(buf)
        op = self._op_label or "reduce"
        with self._entered("reduce_sum", buf.shape, buf.dtype, root):
            t0 = time.perf_counter()
            self._native_leg("reduce_sum", buf, root)
            self._account(op, buf.nbytes, t0, root)
        return buf

    @contextlib.contextmanager
    def _labeled(self, op: str):
        """Attribute nested collective legs to the composite op that
        issued them (outermost label wins)."""
        prev = self._op_label
        self._op_label = prev or op
        try:
            yield
        finally:
            self._op_label = prev

    def allreduce_sum(self, buf: np.ndarray, root: int = 0) -> np.ndarray:
        """reduce_sum then bcast — the composite the reference builds from
        its RdTree + BcTree pair per supernode."""
        with self._entered("allreduce_sum", np.shape(buf),
                            getattr(buf, "dtype", "float64"), root):
            with self._labeled("allreduce"):
                buf = self.reduce_sum(buf, root)
                return self.bcast(buf, root)

    # ---- typed payload layer -------------------------------------------
    # The native segment is f64 (the reference's trees are likewise typed,
    # TreeBcast_slu.hpp:34).  These wrappers carry any shape/dtype payload:
    # complex splits into re/im passes, integers ride the f64 mantissa
    # (exact below 2^53 — dimensions/indices are far below), and payloads
    # longer than max_len stream through in chunks.

    def _f64_op(self, flat: np.ndarray, root: int, op) -> np.ndarray:
        out = np.empty(flat.size, dtype=np.float64)
        step = self.max_len
        for lo in range(0, flat.size, step):
            hi = min(lo + step, flat.size)
            out[lo:hi] = op(np.ascontiguousarray(flat[lo:hi],
                                                 dtype=np.float64),
                            root=root)[:hi - lo]
        return out

    def _payload_op(self, arr: np.ndarray, root: int, op) -> np.ndarray:
        arr = np.asarray(arr)
        flat = arr.reshape(-1)
        if np.issubdtype(arr.dtype, np.complexfloating):
            re = self._f64_op(flat.real, root, op)
            im = self._f64_op(flat.imag, root, op)
            out = (re + 1j * im).astype(arr.dtype)
        else:
            out = self._f64_op(flat, root, op).astype(arr.dtype)
        return out.reshape(arr.shape)

    def bcast_any(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        """Broadcast a payload of any dtype/shape (returns a new array)."""
        arr = np.asarray(arr)
        with self._entered("bcast_any", arr.shape, arr.dtype, root):
            return self._payload_op(arr, root, self.bcast)

    def reduce_sum_any(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        """Sum-reduce a payload of any dtype/shape onto root."""
        arr = np.asarray(arr)
        with self._entered("reduce_sum_any", arr.shape, arr.dtype, root):
            return self._payload_op(arr, root, self.reduce_sum)

    def allreduce_sum_any(self, arr: np.ndarray, root: int = 0) -> np.ndarray:
        arr = np.asarray(arr)
        with self._entered("allreduce_sum_any", arr.shape, arr.dtype,
                            root):
            return self._payload_op(arr, root, self.allreduce_sum)

    # ---- byte / object layer -------------------------------------------
    # The native bcast is a pure memcpy through the f64 slots, so raw
    # bytes ride bit-exactly reinterpreted as float64 (no arithmetic ever
    # touches them — reductions would, so only broadcast is offered).

    def bcast_bytes(self, data: bytes | None, root: int = 0) -> bytes:
        """Broadcast a byte string from root (non-root passes None)."""
        # digest carries op/site/seq only: non-root ranks don't know the
        # length yet (the inner length bcast is depth-exempt)
        with self._entered("bcast_bytes", (), "bytes", root):
            with self._labeled("bcast_bytes"):
                return self._bcast_bytes(data, root)

    def _bcast_bytes(self, data: bytes | None, root: int = 0) -> bytes:
        if self.rank == root:
            n = len(data)
            payload = np.frombuffer(
                data + b"\0" * (-n % 8), dtype=np.float64)
        else:
            n = 0
            payload = None
        n = int(self.bcast_any(np.array([n], dtype=np.int64),
                               root=root)[0])
        if self.rank != root:
            payload = np.zeros((n + 7) // 8, dtype=np.float64)
        out = self._f64_op(payload, root, self.bcast)
        return out.tobytes()[:n]

    def bcast_obj(self, obj=None, root: int = 0):
        """Broadcast a picklable object from root (non-root passes None).
        Carries the analysis artifacts of the distributed-factors tier —
        the role the reference's MPI_Bcast of perm vectors plays
        (pdgssvx.c:816-831), widened to whole symbolic/plan structures.
        The root gets its ORIGINAL object back (no redundant second copy
        through pickle on the rank whose memory matters most)."""
        import pickle
        with self._entered("bcast_obj", (), "obj", root):
            blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL) \
                if self.rank == root else None
            data = self.bcast_bytes(blob, root=root)
            return obj if self.rank == root else pickle.loads(data)

    def close(self, unlink: bool | None = None):
        if self._h:
            if unlink is None:
                unlink = self._created
            if self._verifier is not None:
                self._verifier.close(unlink)
            if self._detector is not None:
                self._detector.close(unlink)
            self._lib.slu_tree_detach(self._h, self.name,
                                      1 if unlink else 0)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FaultyTreeComm(TreeComm):
    """Fault-injection wrapper for the distributed tier's robustness tests.

    Simulates an unreliable transport at the *chunk* layer of the typed
    collectives (_f64_op — every bcast_any/reduce_sum_any/allreduce/
    bcast_obj payload streams through it):

      * reorder — a payload's chunks are delivered in a shuffled order
        (each result still lands in its own slice, the sequence-number
        reassembly a real transport would do);
      * drop    — a chunk's collective runs but its delivery is discarded;
        after a simulated timeout (`delay` seconds) the chunk is
        retransmitted, up to `max_retries` times — the timeout-with-retry
        discipline on collectives;
      * dup     — a chunk is delivered twice; the duplicate overwrites the
        same slice with the same data (idempotent receive).

    The fault schedule is a deterministic function of (seed, draw index)
    and every rank draws in the same order, so ALL ranks agree on which
    chunk operations run and how many times: faults perturb ordering and
    repetition, never collective matching (a mismatched schedule would
    deadlock the shared-memory trees, exactly like mismatched MPI
    collectives).  Counts land in .fault_counts.

    Enable via make_treecomm + SLU_TPU_FAULTS (see below) or construct
    directly in tests.
    """

    def __init__(self, name, n_ranks, rank, max_len: int = 4096,
                 create: bool | None = None, drop: float = 0.0,
                 dup: float = 0.0, reorder: float = 0.0,
                 delay: float = 0.0, seed: int = 0, max_retries: int = 3):
        super().__init__(name, n_ranks, rank, max_len=max_len,
                         create=create)
        self._p_drop = float(drop)
        self._p_dup = float(dup)
        self._p_reorder = float(reorder)
        self._delay = float(delay)
        self._max_retries = int(max_retries)
        # one stream, consumed in lock-step on every rank (all ranks make
        # the same collective calls with the same payload sizes)
        self._frng = np.random.default_rng(seed)
        self.fault_counts = {"drop": 0, "dup": 0, "reorder": 0}

    def _f64_op(self, flat: np.ndarray, root: int, op) -> np.ndarray:
        out = np.empty(flat.size, dtype=np.float64)
        step = self.max_len
        m = self._metrics
        offsets = list(range(0, flat.size, step))
        if len(offsets) > 1 and self._frng.random() < self._p_reorder:
            self._frng.shuffle(offsets)
            self.fault_counts["reorder"] += 1
            if m is not None:
                m.inc("slu_comm_faults_total", 1.0, fault="reorder")
        for lo in offsets:
            hi = min(lo + step, flat.size)
            for attempt in range(self._max_retries + 1):
                # each attempt sends a fresh COPY of the original payload:
                # the legs run in place, so a retransmission of the slice
                # itself would re-sum an already-reduced chunk; a copy
                # carries the same contribution, so the reduction result
                # is identical (idempotent resend)
                res = op(np.array(flat[lo:hi], dtype=np.float64),
                         root=root)[:hi - lo]
                if (attempt < self._max_retries
                        and self._frng.random() < self._p_drop):
                    self.fault_counts["drop"] += 1
                    if m is not None:
                        m.inc("slu_comm_faults_total", 1.0, fault="drop")
                        m.inc("slu_comm_retries_total", 1.0)
                    if self._delay:
                        time.sleep(self._delay)   # the simulated timeout
                    continue
                break
            if self._frng.random() < self._p_dup:
                self.fault_counts["dup"] += 1
                if m is not None:
                    m.inc("slu_comm_faults_total", 1.0, fault="dup")
                res = op(np.array(flat[lo:hi], dtype=np.float64),
                         root=root)[:hi - lo]
            out[lo:hi] = res
        return out


def parse_fault_spec(spec: str) -> dict:
    """Parse 'drop=0.1,dup=0.05,reorder=0.2,delay=0.001,seed=7' into
    FaultyTreeComm kwargs; unknown keys raise (a typo'd knob silently
    injecting nothing would defeat the test)."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key in ("seed", "max_retries"):
            out[key] = int(val)
        elif key in ("drop", "dup", "reorder", "delay"):
            out[key] = float(val)
        else:
            raise ValueError(f"unknown fault-injection knob {key!r}")
    return out


def make_treecomm(name, n_ranks, rank, max_len: int = 4096,
                  create: bool | None = None) -> TreeComm:
    """Env-gated TreeComm factory: with SLU_TPU_FAULTS set (e.g.
    'drop=0.2,reorder=0.2,seed=7') every attachment becomes a
    FaultyTreeComm — all ranks read the same environment, so the
    deterministic schedules agree.  Unset/empty: a plain TreeComm."""
    from superlu_dist_tpu_torch.utils.options import env_str
    spec = env_str("SLU_TPU_FAULTS").strip()
    if not spec:
        return TreeComm(name, n_ranks, rank, max_len=max_len, create=create)
    return FaultyTreeComm(name, n_ranks, rank, max_len=max_len,
                          create=create, **parse_fault_spec(spec))
