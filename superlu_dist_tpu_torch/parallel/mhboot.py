"""Per-rank bootstrap for multi-process drivers.

The role mpiexec + MPI_Init play for the reference's pddrive
(EXAMPLE/pddrive.c:29): each rank joins the shared-memory tree domain
(:func:`attach_tree`) before its first collective.  Port of the JAX
package's ``parallel/mhboot.py`` without ``boot``, which joins a
multi-process device world: that belongs to the mesh tier (ROADMAP.md
Queue 1 item 8).
"""

from __future__ import annotations

import time


def attach_tree(shm: str, nproc: int, rank: int, max_len: int = 4096,
                retries: int = 600, delay: float = 0.1):
    """Join the POSIX-shm tree domain; rank 0 creates, others retry
    until the creator has it up (the MPI_Comm_dup moment).  ``retries``
    × ``delay`` bounds the wait: a peer started before its root must
    cover the time until the root attaches."""
    from superlu_dist_tpu_torch.parallel.treecomm import TreeComm
    if rank == 0:
        return TreeComm(shm, nproc, 0, max_len=max_len, create=True)
    for _ in range(retries):
        try:
            return TreeComm(shm, nproc, rank, max_len=max_len,
                            create=False)
        except OSError:
            time.sleep(delay)
    raise TimeoutError(f"treecomm attach timeout for {shm!r}")
