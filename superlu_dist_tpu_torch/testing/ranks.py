"""Spawned CPU ranks for the distributed driver.

A process that holds a CUDA context must not fork a rank, so the peers of
a distributed run (parallel/pgssvx.py, parallel/recover.py) are started
with ``multiprocessing.get_context("spawn")``: each imports the package
afresh and runs :func:`peer_main` over its list of :class:`RankJob`\\ s,
one result record per job on a queue.  A peer runs on the CPU
(``device="cpu"``) and never touches ``torch.cuda``: its last record
says whether a CUDA context exists in it.  The caller runs rank 0 itself
with :func:`run_job` (on the card, or on the CPU), so the root's work and
the peers' overlap as in a real run.

Peers are daemons: if the caller dies or raises, they are terminated at
its exit instead of holding it in a join.  :func:`stop_peers` joins (or
terminates) them and reports what is left.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import time

import numpy as np


@dataclasses.dataclass
class RankJob:
    """One distributed call a rank takes part in.

    ``kind`` is "pgssvx" (one call on a domain the rank joins with
    ``parallel/mhboot.attach_tree``), "pgssvx_ft" (the recovery epoch
    loop, which forms its own domains) or "allreduce" (``ops``
    allreduces of ``np.ones(4)`` on a joined domain: the failure
    detector's own scenarios).  ``a_source`` / ``b_source`` deal this
    rank's block rows (``parallel/recover.RowBlockSource`` /
    ``VectorBlockSource``).  ``env`` is set in the rank's environment
    before the job (a chaos spec for one rank); ``attach_s`` bounds the
    wait for the root's domain; ``reuse_lu`` hands the rank's handle from
    its previous job to this one (only the root has one); ``hold_s``
    keeps the rank alive that long after the job (a survivor that exited
    at once would be counted among the dead by a slower peer)."""

    kind: str
    name: str
    n_ranks: int
    options: object
    a_source: object
    b_source: object
    max_len: int = 4096
    env: dict = dataclasses.field(default_factory=dict)
    attach_s: float = 120.0
    reuse_lu: bool = False
    ops: int = 0
    hold_s: float = 0.0


class GallerySystem:
    """A gallery matrix and a right-hand side B = A·X (X standard normal
    from ``seed``; ``nrhs`` None: one column) named, not held: each
    process builds them at first use, the same bits everywhere.  A
    rank's job then pickles to a few hundred bytes, so starting a peer
    does not wait on the pipe while the child imports the package to
    unpickle a matrix.  ``a_rows`` / ``b_rows`` are the block-row sources
    of ``parallel/recover`` (``RowBlockSource``' partition)."""

    def __init__(self, name: str, args=(), seed: int = 0, nrhs=None):
        self.name, self.args = name, tuple(args)
        self.seed, self.nrhs = int(seed), nrhs
        self._a = self._b = None

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items()
                if k not in ("_a", "_b")}

    def __setstate__(self, state):
        self.__dict__.update(state, _a=None, _b=None)

    def matrix(self):
        if self._a is None:
            from superlu_dist_tpu_torch.models import gallery
            self._a = getattr(gallery, self.name)(*self.args)
        return self._a

    def rhs(self):
        if self._b is None:
            a = self.matrix()
            shape = (a.n_rows,) if self.nrhs is None else (a.n_rows,
                                                           self.nrhs)
            self._b = a.matvec(
                np.random.default_rng(self.seed).standard_normal(shape))
        return self._b

    def a_rows(self, n_ranks: int, rank: int):
        from superlu_dist_tpu_torch.parallel.recover import RowBlockSource
        return RowBlockSource(self.matrix())(n_ranks, rank)

    def b_rows(self, n_ranks: int, rank: int):
        from superlu_dist_tpu_torch.parallel.recover import VectorBlockSource
        return VectorBlockSource(self.rhs())(n_ranks, rank)


def run_job(job: RankJob, rank: int, device, lu=None) -> dict:
    """Run ``job`` as ``rank`` and return its record: x, info, the
    rank's lu_out, the wall seconds, the time (``time.time()``) the rank
    joined the domain and its longest heartbeat gap (with
    ``SLU_TPU_COMM_TIMEOUT_S`` armed), or ``error`` naming the exception
    a rank raised (a RankFailureError's dead ranks, op and call site under
    ``failure``)."""
    from superlu_dist_tpu_torch.parallel.mhboot import attach_tree
    from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
    from superlu_dist_tpu_torch.parallel.recover import pgssvx_ft
    from superlu_dist_tpu_torch.utils.errors import RankFailureError

    os.environ.update(job.env)
    rec = {"rank": rank, "name": job.name}
    lu_out = {}
    t0 = time.perf_counter()
    try:
        if job.kind == "allreduce":
            tc = attach_tree(job.name, job.n_ranks, rank,
                             max_len=job.max_len,
                             retries=max(int(job.attach_s / 0.05), 1),
                             delay=0.05)
            t0 = time.perf_counter()
            try:
                x = [tc.allreduce_sum_any(np.ones(4)) for _ in range(job.ops)]
                x, info = np.stack(x), 0
            finally:
                tc.close()
        elif job.kind == "pgssvx":
            tc = attach_tree(job.name, job.n_ranks, rank,
                             max_len=job.max_len,
                             retries=max(int(job.attach_s / 0.05), 1),
                             delay=0.05)
            rec["attached_at"] = time.time()
            t0 = time.perf_counter()
            try:
                x, info = pgssvx(tc, job.options,
                                 job.a_source(job.n_ranks, rank),
                                 job.b_source(job.n_ranks, rank),
                                 lu=lu if job.reuse_lu else None,
                                 lu_out=lu_out, device=device)
                det = tc._detector
                rec["beat_gap_s"] = (None if det is None
                                     else det.max_beat_gap_s)
            finally:
                tc.close()
        elif job.kind == "pgssvx_ft":
            x, info = pgssvx_ft(job.name, job.n_ranks, rank, job.options,
                                job.a_source, job.b_source,
                                max_len=job.max_len, lu_out=lu_out,
                                device=device)
        else:
            raise ValueError(f"unknown rank job kind {job.kind!r}")
        rec.update(x=x, info=info)
    except Exception as exc:
        rec["error"] = f"{type(exc).__name__}: {exc}"
        if isinstance(exc, RankFailureError):
            rec["failure"] = {"dead": exc.dead_ranks, "op": exc.op,
                              "site": exc.site}
    finally:
        for k in job.env:
            os.environ.pop(k, None)
    rec["seconds"] = time.perf_counter() - t0
    if job.hold_s:
        time.sleep(job.hold_s)
    rec["lu_out"] = lu_out
    return rec


def _shippable(rec: dict) -> dict:
    """A peer's record without its handle (factors never leave a rank):
    lu_out keeps the report, the summary, the timings and the recovery
    facts."""
    out = dict(rec)
    lu_out = rec.get("lu_out", {})
    out["lu_out"] = {k: lu_out[k] for k in (
        "solve_report", "stats_summary", "timings", "ft_events",
        "recovered") if k in lu_out}
    return out


def peer_main(rank: int, jobs: list, results) -> None:
    """A spawned peer's entry point: run ``jobs`` in order as ``rank`` on
    the CPU, putting one record per job on ``results``, then a last
    record ``{"rank", "done": True, "cuda_initialized", "started_at"}``."""
    started = time.time()
    import torch
    lu = None
    for i, job in enumerate(jobs):
        rec = run_job(job, rank, "cpu", lu=lu)
        lu = rec["lu_out"].get("lu", lu)
        rec["job"] = i
        results.put(_shippable(rec))
    results.put({"rank": rank, "done": True, "started_at": started,
                 "cuda_initialized": bool(torch.cuda.is_initialized())})


def run_thread_ranks(name: str, n_ranks: int, fn, max_len: int = 64,
                     classes=None, timeout: float = 60.0) -> dict:
    """Run ``fn(tc)`` on ``n_ranks`` thread ranks of a fresh domain
    ``name`` (rank 0 creates it before the others attach; ctypes releases
    the GIL in every native leg, so the threads run the collectives
    concurrently); returns {rank: result, or the exception it raised}.
    ``classes`` picks a rank's communicator class ({rank: class}, default
    ``TreeComm``: a JAX-package TreeComm joins the same domain).  Raises
    TimeoutError when a rank is still running after ``timeout``."""
    import threading
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    classes = classes or {}
    comms = [classes.get(r, TreeComm)(name, n_ranks, r, max_len=max_len,
                                      create=r == 0)
             for r in range(n_ranks)]
    out = {}

    def go(r):
        try:
            out[r] = fn(comms[r])
        except Exception as exc:      # handed to the caller
            out[r] = exc

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    hung = [r for r, t in enumerate(threads) if t.is_alive()]
    if hung:
        raise TimeoutError(f"thread ranks {hung} still running after "
                           f"{timeout} s")
    for tc in comms[::-1]:
        tc.close()
    return out


def spawn_peers(jobs_by_rank: dict):
    """Start one spawned daemon process per rank of ``jobs_by_rank``
    ({rank: [RankJob, ...]}); returns (processes, results queue, the
    ``time.time()`` of the spawn)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    spawned_at = time.time()
    procs = {}
    for rank, jobs in sorted(jobs_by_rank.items()):
        p = ctx.Process(target=peer_main, args=(rank, jobs, results),
                        name=f"slu-peer-r{rank}", daemon=True)
        p.start()
        procs[rank] = p
    return procs, results, spawned_at


def collect(results, want: int, timeout: float, procs=None) -> list:
    """``want`` records from ``results`` within ``timeout`` seconds;
    raises TimeoutError (naming the peers that died) when they do not
    all arrive."""
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < want:
        left = deadline - time.monotonic()
        try:
            out.append(results.get(timeout=max(min(left, 5.0), 0.01)))
        except queue_mod.Empty:
            dead = {r: p.exitcode for r, p in (procs or {}).items()
                    if not p.is_alive()}
            if left <= 0:
                raise TimeoutError(
                    f"{len(out)} of {want} rank records in {timeout} s; "
                    f"exited peers: {dead}") from None
    return out


def stop_peers(procs: dict, timeout: float = 30.0) -> dict:
    """Join every peer (terminating one that outlives ``timeout``);
    returns {rank: exit code}."""
    deadline = time.monotonic() + timeout
    for p in procs.values():
        p.join(max(deadline - time.monotonic(), 0.1))
    for p in procs.values():
        if p.is_alive():
            p.terminate()
            p.join(5.0)
    return {r: p.exitcode for r, p in procs.items()}
