"""Rank-failure recovery: shrink-or-respawn epochs over the survivors.

The bounded-wait collectives (parallel/treecomm.py) turn a dead peer
into a structured :class:`RankFailureError` raised on EVERY surviving
rank with an agreed dead-set (the ULFM revoke→agree conversion).  This
module is the third leg — *recover*: re-form the communicator over the
survivors and finish the solve.

One recovery epoch (``Options.ft``):

* ``"shrink"`` — the survivors renumber into a dense rank set, attach a
  fresh epoch domain (``<name>.e<k>`` — its creator unlinks any stale
  segment first, so a crashed epoch can never be rejoined), re-deal the
  input rows over the surviving rank count (the ShyLU-style subdomain
  reassignment, arXiv:2506.05793 — which is exactly a re-run of the
  panalysis/row partitioning over the new rank set), and re-enter
  ``pgssvx`` — with the previous epoch's checkpoint frontier
  (persist/checkpoint.py) threaded through ``resume_from`` so the root
  factorization COMPLETES from where the dead epoch left off instead of
  starting over (bitwise-identical L/U);
* ``"respawn"`` — the lowest surviving rank spawns one replacement
  process per dead rank (the sources must be picklable — see
  :class:`RowBlockSource` — and, per the standard multiprocessing
  "spawn" contract, the caller's ``__main__`` must be import-safe);
  the replacements take over the DEAD ranks' ids in the next epoch, so
  the world size never shrinks;
* ``"abort"`` — the error propagates (the default: policy belongs to
  the caller, not the transport).

Every recovery is recorded: a :class:`FtEvent` in the process-wide
:data:`FT_EVENTS`, an
``ft-shrink``/``ft-respawn`` rung on the SolveReport ladder, a
``slu_ft_recoveries_total`` metric, and a flight-recorder event on
every surviving rank (the RankFailureError construction already dumped
the postmortem ring).

The input contract makes re-dealing possible: ``a_source(n_ranks,
rank)`` / ``b_source(n_ranks, rank)`` return THIS rank's block for the
CURRENT rank count — the serving shape, where the rows come from a
request or a store and can be re-dealt to whoever is still standing.
A rank's private, unrecoverable rows would make shrink impossible by
definition (respawn still works: the world size is preserved).

Port of the JAX package's ``parallel/recover.py``; ``device`` passes
through to ``pgssvx`` (it matters only on the root).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from superlu_dist_tpu_torch.parallel.treecomm import TreeComm, make_treecomm
from superlu_dist_tpu_torch.utils.errors import (CheckpointError,
                                                 RankFailureError)
from superlu_dist_tpu_torch.utils.options import check_ft

#: process-wide record of every rank-failure recovery this process took
#: part in
FT_EVENTS: list = []

#: replacement processes spawned by THIS process (respawn mode); join
#: them via :func:`reap_respawned` once the solve returns
_RESPAWNED: list = []



@dataclasses.dataclass
class FtEvent:
    """One recovery the epoch loop performed."""

    epoch: int                 # the epoch that FAILED
    dead: list                 # original rank ids declared dead
    mode: str                  # "shrink" | "respawn"
    op: str = ""               # collective the failure surfaced in
    resumed: bool = False      # next epoch resumed a checkpoint frontier
    seconds: float = 0.0       # failure -> next-epoch entry


class RowBlockSource:
    """Picklable re-shardable matrix source: deals block rows of one
    global SparseCSR to the current rank set (parallel/dist.py
    partitioning — re-run per epoch, so a shrink re-partitions over the
    survivors)."""

    def __init__(self, a):
        self.a = a

    def __call__(self, n_ranks: int, rank: int):
        from superlu_dist_tpu_torch.parallel.dist import distribute_rows
        return distribute_rows(self.a, n_ranks)[rank]


class VectorBlockSource:
    """Picklable RHS source matching :class:`RowBlockSource`'s row
    partition (the same ceil-step block bounds)."""

    def __init__(self, b):
        self.b = np.asarray(b)

    def __call__(self, n_ranks: int, rank: int):
        n = self.b.shape[0]
        step = -(-n // n_ranks)
        lo = min(rank * step, n)
        hi = min(lo + step, n)
        return self.b[lo:hi]


def _attach_epoch(name: str, n_ranks: int, rank: int, max_len: int,
                  attach_timeout_s: float = 30.0) -> TreeComm:
    """Form one epoch's communicator.  Rank 0 of the NEW numbering
    creates (unlinking any stale same-named segment); the others retry
    until the creator's segment exists — the rendezvous the failed
    epoch's survivors perform concurrently."""
    create = rank == 0
    deadline = time.monotonic() + attach_timeout_s
    while True:
        try:
            return make_treecomm(name, n_ranks, rank, max_len=max_len,
                                 create=create)
        except OSError:
            if create or time.monotonic() >= deadline:
                raise
            time.sleep(0.05)


def _checkpoint_resume_dir(options) -> str | None:
    """The durable frontier of the failed epoch, if one was flushed
    (shared filesystem assumption: the new root can read the old
    root's checkpoint directory)."""
    if not getattr(options, "ckpt_dir", ""):
        return None
    from superlu_dist_tpu_torch.persist.checkpoint import peek
    try:
        meta = peek(options.ckpt_dir)
    except CheckpointError:
        return None
    return options.ckpt_dir if int(meta.get("k", 0)) > 0 else None


def _spawn_replacements(name, n_world, alive, dead, options, a_source,
                        b_source, max_len, epoch, device):
    """Respawn one process per dead rank (spawn context: a process that
    holds a CUDA context must not fork)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    for d in dead:
        p = ctx.Process(
            target=_respawn_worker,
            args=(name, n_world, d, options, a_source, b_source,
                  max_len, epoch, tuple(alive), device),
            name=f"slu-respawn-r{d}e{epoch}")
        p.start()
        _RESPAWNED.append(p)


def _respawn_worker(name, n_world, rank, options, a_source, b_source,
                    max_len, epoch, alive, device):
    """Entry point of a replacement process: join the given epoch as
    the dead rank's successor and run the same FT loop from there."""
    pgssvx_ft(name, n_world, rank, options, a_source, b_source,
              max_len=max_len, start_epoch=epoch, alive=alive,
              device=device)


def reap_respawned(timeout: float = 60.0) -> None:
    """Join replacement processes spawned by this process (they finish
    the same epoch collectives the spawner finished, so this is quick;
    called automatically on successful return of pgssvx_ft)."""
    while _RESPAWNED:
        p = _RESPAWNED.pop()
        p.join(timeout=timeout)


def _record_recovery(lu_out, events) -> None:
    """Stamp the recoveries onto the caller-visible artifacts: the
    lu_out dict, the SolveReport ladder, and the metrics registry."""
    if lu_out is None:
        return
    lu_out["ft_events"] = list(events)
    lu_out["recovered"] = bool(events)
    rep = lu_out.get("solve_report")
    if rep is None:
        stats = lu_out.get("stats")
        rep = getattr(stats, "solve_report", None) if stats else None
    if rep is not None:
        from superlu_dist_tpu_torch.utils.stats import RungRecord
        for ev in events:
            rep.rungs.append(RungRecord(
                name=f"ft-{ev.mode}",
                detail=(f"epoch {ev.epoch} dead={ev.dead} op={ev.op} "
                        f"resumed={ev.resumed}"),
                seconds=ev.seconds))


def pgssvx_ft(name: str, n_ranks: int, rank: int, options, a_source,
              b_source, *, max_len: int = 4096, lu_out=None,
              start_epoch: int = 0, alive=None, max_epochs: int = 8,
              device=None):
    """Fault-tolerant collective solve: pgssvx epochs until success.

    Every participating process calls this with the shared domain
    ``name``, the WORLD size ``n_ranks`` and its own original ``rank``;
    ``a_source``/``b_source`` are the re-shardable input callables
    documented above.  Returns ``(x, info)`` like pgssvx, where ``x``
    is THIS epoch's global solution (every survivor gets it).

    On :class:`RankFailureError` the behavior follows ``options.ft``
    (``SLU_TPU_FT``): abort re-raises; shrink drops the dead ranks and
    re-enters with the survivors; respawn replaces them.  Either way
    the next epoch threads the failed epoch's checkpoint frontier into
    the root factorization (``resume_from``) when one was flushed, so
    completed factor groups are never recomputed — and a recovered
    solve is bitwise-identical to an undisturbed one.
    """
    from superlu_dist_tpu_torch.testing.chaos import bind_rank, bound_rank
    # the epochs' chaos identity is this call's: the process leaves it
    # with the identity it came with (a later server or factorization in
    # the same process is not in a recovery epoch)
    entry = bound_rank()
    try:
        return _ft_epochs(name, n_ranks, rank, options, a_source, b_source,
                          max_len, lu_out, start_epoch, alive, max_epochs,
                          device)
    finally:
        bind_rank(*entry)


def _ft_epochs(name, n_ranks, rank, options, a_source, b_source, max_len,
               lu_out, start_epoch, alive, max_epochs, device):
    """pgssvx_ft's epoch loop."""
    mode = check_ft(options)
    alive = list(range(n_ranks)) if alive is None else list(alive)
    epoch = start_epoch
    events: list = []
    x = info = None
    while True:
        sub_rank = alive.index(rank)
        nm = name if epoch == 0 else f"{name}.e{epoch}"
        tc = _attach_epoch(nm, len(alive), sub_rank, max_len)
        tc.epoch = epoch
        # chaos injections stay scoped to the ORIGINAL identity: a
        # survivor renumbered into a dead rank's slot (or a respawned
        # successor) must not inherit epoch-0 injections
        tc.chaos_rank = rank
        from superlu_dist_tpu_torch.testing.chaos import bind_rank
        bind_rank(rank, epoch)
        resume = _checkpoint_resume_dir(options) if epoch > start_epoch \
            else None
        a_loc = a_source(len(alive), sub_rank)
        b_loc = b_source(len(alive), sub_rank)
        out = lu_out if lu_out is not None else {}
        t_fail = time.monotonic()
        try:
            from superlu_dist_tpu_torch.parallel.pgssvx import pgssvx
            # an unusable frontier degrades ROOT-LOCALLY inside pgssvx
            # (CheckpointError fallback there) — retrying out here would
            # diverge the survivors' collective sequences
            x, info = pgssvx(tc, options, a_loc, b_loc, lu_out=out,
                             resume_from=resume, device=device)
            if events:
                events[-1].resumed = bool(resume)
            _record_recovery(out, events)
            tc.close(unlink=True)
            reap_respawned()
            return x, info
        except RankFailureError as exc:
            tc.close(unlink=True)
            if mode == "abort" or epoch - start_epoch >= max_epochs:
                raise
            dead_orig = sorted(alive[d] for d in exc.dead_ranks)
            ev = FtEvent(epoch=epoch, dead=dead_orig, mode=mode,
                         op=exc.op, seconds=time.monotonic() - t_fail)
            events.append(ev)
            FT_EVENTS.append(ev)
            from superlu_dist_tpu_torch.obs.metrics import get_metrics
            m = get_metrics()
            if m.enabled:
                m.inc("slu_ft_recoveries_total", 1.0, mode=mode)
            from superlu_dist_tpu_torch.obs.flightrec import get_flightrec
            fr = get_flightrec()
            if fr.enabled:
                fr.event("ft-recovery", cat="verify", mode=mode,
                         epoch=epoch, dead=",".join(map(str, dead_orig)))
            survivors = [r for r in alive if r not in dead_orig]
            if mode == "shrink":
                alive = survivors
            else:                      # respawn: world size preserved
                if rank == min(survivors):
                    _spawn_replacements(name, n_ranks, alive, dead_orig,
                                        options, a_source, b_source,
                                        max_len, epoch + 1, device)
            epoch += 1
