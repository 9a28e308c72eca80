"""Mid-factorization checkpoints: the durable completed-group frontier.

Port of the JAX package's ``persist/checkpoint.py``.  The factor loop
(numeric/factor.py) completes one dispatch group at a time; everything up
to a group boundary is a deterministic function of (plan, values,
threshold, dtype, GEMM tier).  A checkpoint therefore is the factored
``(lpanel, upanel)`` pairs of the first ``k`` groups plus the Schur pool
as of that boundary — resuming re-runs groups ``k..`` with the restored
pool and gives factors bit for bit equal to an uninterrupted run.

The port's loop updates the pool in place (and accumulates the tiny-pivot
count in place), so a reference to the pool taken at group ``gi``
describes a later group a moment after.  A frontier is therefore only
ever copied to the host *at a group boundary, from inside the loop*:

* every ``Options.ckpt_every`` completed groups (:meth:`note`), which
  synchronizes the card to copy the pool out;
* on cooperative-deadline expiry and on a numeric breakdown, where the
  loop stands at a boundary (:meth:`flush_latest`);
* on SIGTERM or :func:`flush_active`: the request is recorded and the loop
  honours it at its next boundary (a SIGTERM is then re-delivered to the
  disposition installed before, so the process still ends); if the loop
  never reaches another boundary, the last interval checkpoint stands.

Front artifacts are immutable once written, so an advancing checkpoint
only writes the new groups plus the pool and the manifest — the manifest
replace is the commit point (persist/serial.py).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import threading

import numpy as np
import torch

from superlu_dist_tpu_torch.persist import serial
from superlu_dist_tpu_torch.utils.errors import (CheckpointError,
                                                 CheckpointMismatchError)

# process-wide registry of live checkpointers (for signal flushes) and the
# most recently committed checkpoint path
_ACTIVE: list = []
_LAST_PATH: list = []
_REG_LOCK = threading.Lock()


@dataclasses.dataclass
class ResumeState:
    """A loaded checkpoint, ready to splice into the factor loop."""

    k: int                    # completed dispatch groups
    fronts: list              # k (lpanel, upanel) numpy pairs
    pool: np.ndarray          # Schur pool at the frontier
    tiny: int                 # tiny-pivot count over the first k groups
    meta: dict                # the bundle's manifest meta block
    path: str = ""


class FactorCheckpointer:
    """Checkpoint writer bound to one factorization's identity.

    Constructed by ``numeric_factorize`` when ``ckpt_dir`` or
    ``ckpt_every`` is given; the loop calls :meth:`note` after every
    completed group.  ``every=0`` disables interval flushes but keeps the
    deadline, breakdown and signal flushes armed.  ``thresh`` is the GESP
    threshold as a float (rounded to the factors' real type).
    """

    def __init__(self, dirpath: str, plan, pattern_values, thresh, dtype,
                 every: int = 0, gemm_prec: str = ""):
        self.dirpath = os.path.abspath(dirpath)
        os.makedirs(self.dirpath, exist_ok=True)
        self.every = int(every)
        self.n_groups = len(plan.groups)
        self.plan_fp = serial.plan_fingerprint(plan)
        self.values_fp = serial.values_digest(pattern_values, dtype, thresh,
                                              gemm_prec=gemm_prec)
        self.dtype = serial.dtype_str(dtype)
        self._entries: dict = {}      # manifest entries carried across
                                      # flushes (front files are immutable)
        self._host: list = []         # numpy copies of fronts already saved
        self._latest = None           # (gi, fronts, pool, tiny), valid only
                                      # until the next group starts
        self._pending = None          # reason of a flush requested from
                                      # outside the loop
        self.tiny_base = 0            # tiny count of a resumed frontier
        self._flushed_k = -1
        self._lock = threading.Lock()
        self.last_path = None
        with _REG_LOCK:
            _ACTIVE.append(self)
        _arm_sigterm_once()

    def seed(self, resume: ResumeState) -> None:
        """Carry a resumed frontier: its fronts are already on the host and
        its tiny-pivot count joins every later flush."""
        self._host = list(resume.fronts)
        self.tiny_base = int(resume.tiny)

    # ---- loop-facing hooks ----------------------------------------------
    def note(self, gi: int, fronts, pool, tiny) -> None:
        """Group ``gi`` just completed: the loop stands at boundary
        ``gi + 1``.  Flushes on the interval and for a pending request."""
        self._latest = (gi, fronts, pool, tiny)
        if self.every and (gi + 1) % self.every == 0:
            self.flush(gi + 1, fronts, pool, tiny, reason="interval")
        if self._pending is not None:
            self.flush_latest(self._pending)
            self._pending = None
            _redeliver_signal()

    def flush(self, k: int, fronts, pool, tiny, reason: str) -> str:
        """Commit frontier ``k`` (the first ``k`` groups are durable).
        Must be called at a group boundary: the pool and ``tiny`` are
        copied to the host here (synchronizing the device).  Returns the
        bundle path."""
        if isinstance(pool, torch.Tensor) and pool.is_cuda:
            # offloaded fronts are copied to host memory on a side stream:
            # they are whole once the card is idle (and they are stored
            # from where they lie, with no second copy).  The wait needs
            # no lock, so it happens before the flush lock is taken.
            torch.cuda.synchronize(pool.device)
        with self._lock:
            tiny_now = int(tiny) + self.tiny_base
            pool_np = serial.host_array(pool)
            while len(self._host) < k:
                lp, up = fronts[len(self._host)]
                self._host.append((serial.host_array(lp),
                                   serial.host_array(up)))
            # the flush lock exists to serialize exactly these bundle
            # writes (interval flush vs deadline/SIGTERM flush racing on
            # one dirpath): the I/O IS the guarded operation
            for g in range(k):
                lp, up = self._host[g]
                serial.write_array(  # slulint: disable=SLU109
                    self.dirpath, f"front_{g:05d}_l", lp, self._entries,
                    skip_existing=True)
                serial.write_array(  # slulint: disable=SLU109
                    self.dirpath, f"front_{g:05d}_u", up, self._entries,
                    skip_existing=True)
            serial.write_array(  # slulint: disable=SLU109
                self.dirpath, "pool", pool_np, self._entries)
            meta = {
                "k": int(k),
                "n_groups": self.n_groups,
                "tiny": tiny_now,
                "factor_dtype": self.dtype,
                "plan_fingerprint": self.plan_fp,
                "values_digest": self.values_fp,
                "reason": reason,
            }
            path = serial.write_manifest(  # slulint: disable=SLU109
                self.dirpath, "factor_checkpoint", meta, self._entries)
            self._flushed_k = k
            self.last_path = path
            with _REG_LOCK:
                _LAST_PATH[:] = [path]
            return path

    def flush_latest(self, reason: str) -> str | None:
        """Flush the most recent completed frontier.  Called by the loop at
        a group boundary (deadline, breakdown, a pending request), where
        the noted pool still describes that boundary.  Returns the bundle
        path, the previous durable path if nothing newer exists, or None
        when no frontier exists at all."""
        latest = self._latest
        if latest is None:
            return self.last_path
        gi, fronts, pool, tiny = latest
        if gi + 1 <= self._flushed_k:
            return self.last_path       # nothing newer than on disk
        return self.flush(gi + 1, fronts, pool, tiny, reason=reason)

    def complete(self, cleanup: bool = True) -> None:
        """The factorization ended: deregister and drop the live refs.  A
        successful run (``cleanup``) removes the checkpoint — the durable
        artifact of a completed factorization is the saved handle
        (persist.save_lu).  A flush requested since the last boundary is
        honoured first (the loop's end is a boundary), and then the run
        is not cleaned up."""
        if self._pending is not None:
            self.flush_latest(self._pending)
            self._pending = None
            cleanup = False
        with _REG_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        self._latest = None
        if cleanup and self.last_path:
            shutil.rmtree(self.dirpath, ignore_errors=True)
            with _REG_LOCK:
                if _LAST_PATH and _LAST_PATH[0] == self.last_path:
                    _LAST_PATH[:] = []
            self.last_path = None
        _redeliver_signal()


# ---------------------------------------------------------------------------
# process-wide flush / query (signal handlers, postmortems)
# ---------------------------------------------------------------------------

def flush_active(reason: str) -> str | None:
    """Ask every live checkpointer to flush its frontier at its loop's
    next group boundary (never raises, touches no device memory).
    Returns the last committed path, which stands until then, or None."""
    with _REG_LOCK:
        active = list(_ACTIVE)
        last = _LAST_PATH[0] if _LAST_PATH else None
    for ck in active:
        ck._pending = reason        # read by the loop at its next boundary
    return last


def last_checkpoint() -> str | None:
    """Path of the most recently committed checkpoint in this process, or
    None."""
    with _REG_LOCK:
        return _LAST_PATH[0] if _LAST_PATH else None


_sigterm_armed = []
_deferred = []      # [previous SIGTERM disposition] once a SIGTERM waits
                    # for a loop boundary


def _chain(prev) -> None:
    """Hand SIGTERM to the disposition installed before ours."""
    if callable(prev):
        prev(signal.SIGTERM, None)
    elif prev is not signal.SIG_IGN:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        os.kill(os.getpid(), signal.SIGTERM)


def _redeliver_signal() -> None:
    """After the flush a SIGTERM waited for: send it again, now to be
    handed on (the handler runs in the main thread)."""
    if _deferred and _deferred[0] is not None:
        _deferred[0] = None
        os.kill(os.getpid(), signal.SIGTERM)


def _arm_sigterm_once() -> None:
    """Install a SIGTERM disposition that asks the live checkpointers to
    flush at their next group boundary and defers the signal until then;
    with none live (or once the flush is done) it hands the signal to the
    disposition installed before.  Main thread only; skipped elsewhere."""
    if _sigterm_armed:
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            with _REG_LOCK:
                live = bool(_ACTIVE)
            if live and not _deferred:
                _deferred.append(prev)
                flush_active("SIGTERM")
                return
            _chain(prev)

        signal.signal(signal.SIGTERM, handler)
        _sigterm_armed.append(True)
    except (ValueError, OSError, RuntimeError):
        pass


# ---------------------------------------------------------------------------
# loading / resume
# ---------------------------------------------------------------------------

def peek(dirpath: str) -> dict:
    """Manifest meta of a checkpoint without loading its arrays."""
    return serial.read_manifest(dirpath, kind="factor_checkpoint")["meta"]


def load_checkpoint(dirpath: str, plan=None, pattern_values=None,
                    thresh=None, dtype=None,
                    gemm_prec: str = "") -> ResumeState:
    """Load and verify a factor checkpoint.

    With ``plan``/``pattern_values``/``thresh``/``dtype`` (and, on the
    driver path, the resolved ``gemm_prec`` tier) given, the checkpoint's
    identity fingerprints must match — a frontier computed from a
    different schedule or different values is never spliced into this
    run (:class:`CheckpointMismatchError`).  Every artifact is
    digest-verified on read (corruption/truncation raise
    :class:`CheckpointCorruptError`)."""
    doc = serial.read_manifest(dirpath, kind="factor_checkpoint")
    meta = doc["meta"]
    k = int(meta["k"])
    if plan is not None:
        if serial.plan_fingerprint(plan) != meta["plan_fingerprint"]:
            raise CheckpointMismatchError(
                f"checkpoint at {dirpath!r} was written for a different "
                "factorization plan (schedule/bucket/amalgamation knobs "
                "or the sparsity pattern changed) — refactor from "
                "scratch instead of resuming")
        if k > len(plan.groups):
            raise CheckpointError(
                f"checkpoint frontier k={k} exceeds the plan's "
                f"{len(plan.groups)} groups")
    if pattern_values is not None:
        if dtype is None or thresh is None:
            raise CheckpointError(
                "value verification needs dtype and thresh alongside "
                "pattern_values")
        vd = serial.values_digest(pattern_values, dtype, thresh,
                                  gemm_prec=gemm_prec)
        if vd != meta["values_digest"]:
            raise CheckpointMismatchError(
                f"checkpoint at {dirpath!r} was computed from different "
                "numeric values (or dtype/threshold/GEMM-precision "
                "tier) — resuming would splice stale panels; refactor "
                "instead")
    fronts = [(serial.read_array(dirpath, f"front_{g:05d}_l", doc),
               serial.read_array(dirpath, f"front_{g:05d}_u", doc))
              for g in range(k)]
    pool = serial.read_array(dirpath, "pool", doc)
    return ResumeState(k=k, fronts=fronts, pool=pool,
                       tiny=int(meta["tiny"]), meta=meta,
                       path=os.path.abspath(dirpath))
