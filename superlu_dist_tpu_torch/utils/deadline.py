"""Cooperative deadlines for the factor loop.

``Options.deadline_s`` bounds how long a factorization may run.  The
check is cooperative: the factor loop polls between dispatch groups (the
natural consistent-state boundary), writes a checkpoint of the completed
frontier first (when checkpointing is armed), and raises a structured
:class:`~superlu_dist_tpu_torch.utils.errors.DeadlineExceededError` —
never a mid-kernel abort, so the durable state is always a clean group
boundary.  Port of the JAX package's ``utils/deadline.py`` for one
process; its collective decision over a ``comm`` belongs to the
multi-GPU tier (ROADMAP.md Queue 1 item 8) and is not ported.
"""

from __future__ import annotations

import time

from superlu_dist_tpu_torch.utils.errors import DeadlineExceededError


class Deadline:
    """One factorization's deadline clock (single process)."""

    def __init__(self, seconds: float, comm=None):
        if comm is not None:
            raise NotImplementedError(
                "a collective deadline (comm=) belongs to the multi-GPU tier, "
                "which is not ported (ROADMAP.md Queue 1 item 8)")
        self.seconds = float(seconds)
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
        error."""
        self.polls += 1
        if not self.expired_local():
            return
        path = None
        if on_expire is not None:
            try:
                path = on_expire()
            except Exception:
                path = None
        raise DeadlineExceededError(
            deadline_s=self.seconds, elapsed_s=self.elapsed(), where=where,
            checkpoint_path=path)
