"""Cooperative deadlines for the factor loop.

``Options.deadline_s`` bounds how long a factorization may run.  The
check is cooperative: the factor loop polls between dispatch groups (the
natural consistent-state boundary), writes a checkpoint of the completed
frontier first (when checkpointing is armed), and raises a structured
:class:`~superlu_dist_tpu_torch.utils.errors.DeadlineExceededError` —
never a mid-kernel abort, so the durable state is always a clean group
boundary.  Port of the JAX package's ``utils/deadline.py``.

Multi-rank discipline: where every rank runs the same group loop, the
polls line up one for one across ranks.  With a ``comm`` (a TreeComm),
each poll allreduces an expired flag — the DECISION is collective, so
either every rank raises together or none does.  A single rank reading
its local clock and bailing out alone would strand its peers inside the
next collective; the flag allreduce makes that impossible by
construction, and runs clean under SLU_TPU_VERIFY_COLLECTIVES since
every rank enters the identical allreduce sequence.
"""

from __future__ import annotations

import time

import numpy as np

from superlu_dist_tpu_torch.utils.errors import DeadlineExceededError


class Deadline:
    """One factorization's deadline clock.

    ``comm`` (optional, anything with ``allreduce_sum_any``) makes every
    poll collective; ``poll_every`` thins the collective exchanges to one
    per N polls (the LOCAL clock is still read every poll, but a lone rank
    never acts on it — expiry is latched and only honored at the next
    collective exchange).  All ranks must construct with the same
    ``poll_every``.
    """

    def __init__(self, seconds: float, comm=None, poll_every: int = 1):
        self.seconds = float(seconds)
        self.comm = comm
        self.poll_every = max(int(poll_every), 1)
        self.t0 = time.perf_counter()
        self.polls = 0

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def expired_local(self) -> bool:
        return self.elapsed() > self.seconds

    def poll(self, where: str = "", on_expire=None) -> None:
        """Check the deadline at a consistent-state boundary.

        ``on_expire`` runs before the raise (the checkpoint-flush hook);
        its return value, if truthy, becomes ``checkpoint_path`` on the
        error.  With a comm, the exchange (and therefore the raise) is
        collective — identical on every rank, and ``expired_ranks`` on the
        error counts the ranks whose clocks ran out."""
        self.polls += 1
        local = self.expired_local()
        if self.comm is None:
            if not local:
                return
            expired = 0
        else:
            if self.polls % self.poll_every:
                return
            flag = np.zeros(1)
            flag[0] = 1.0 if local else 0.0
            expired = int(self.comm.allreduce_sum_any(flag)[0])
            if expired == 0:
                return
        path = None
        if on_expire is not None:
            try:
                path = on_expire()
            except Exception:
                path = None
        raise DeadlineExceededError(
            deadline_s=self.seconds, elapsed_s=self.elapsed(), where=where,
            checkpoint_path=path, expired_ranks=expired)
